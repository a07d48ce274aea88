"""Host-streamed PQ training on a corpus larger than device memory — the
config-#5 capability demo (BASELINE.json: 100M 768-d vectors, ~307 GB,
which fits no card's memory).

Generates a synthetic fvecs corpus on disk, then runs
:func:`reductive_tpu.train_pq_streamed`: every Lloyd's iteration
re-streams the corpus through the native double-buffered reader into the
per-batch statistics step; device-resident state is just codebooks +
statistics (a few MB).

Reports rows/s/iteration for the streamed pass, plus the device-only rate
of the same step on a resident batch — the gap is the host read and the
host-to-device copy.

Usage:
    python benches/streaming_train.py --gb 18 --d 128 --iters 2 --bf16
    python benches/streaming_train.py --gb 0.5 --iters 2   # smoke test
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse
import json
import os
import time

import numpy as np

import jax
import jax.numpy as jnp


def generate_corpus(path: str, n_rows: int, d: int, seed: int = 0) -> None:
    """Clustered synthetic data (mixture of Gaussians) written in chunks."""
    from reductive_tpu.native import write_fvecs

    rs = np.random.default_rng(seed)
    centers = (rs.standard_normal((256, d), dtype=np.float32)) * 2.0
    chunk = 1 << 20
    if os.path.exists(path):
        os.remove(path)
    t0 = time.perf_counter()
    for off in range(0, n_rows, chunk):
        b = min(chunk, n_rows - off)
        which = rs.integers(0, centers.shape[0], b)
        x = centers[which] + rs.standard_normal((b, d), dtype=np.float32)
        write_fvecs(path, x, append=True)
    print(f"generated {n_rows} x {d} rows in {time.perf_counter() - t0:.0f}s "
          f"({n_rows * (d + 1) * 4 / 1e9:.1f} GB on disk)", flush=True)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--gb", type=float, default=18.0,
                   help="corpus size in GB of f32 payload (HBM is 16)")
    p.add_argument("--d", type=int, default=128)
    p.add_argument("--m", type=int, default=16)
    p.add_argument("--bits", type=int, default=8)
    p.add_argument("--iters", type=int, default=2)
    p.add_argument("--batch", type=int, default=1 << 18)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 wire transfer (halves host-link bytes)")
    p.add_argument("--path", default="/tmp/streamed_corpus.fvecs")
    p.add_argument("--keep", action="store_true")
    args = p.parse_args()

    from reductive_tpu import train_pq_streamed
    from reductive_tpu.native import VecsReader

    n_rows = int(args.gb * 1e9 / (4 * args.d))
    generate_corpus(args.path, n_rows, args.d)

    from reductive_tpu.dispatch import use_kernel
    from reductive_tpu.utils import enable_compile_cache

    enable_compile_cache()
    on_gpu = use_kernel("encode")
    transfer = jnp.bfloat16 if args.bf16 else None
    results = {
        "corpus_rows": n_rows,
        "corpus_gb_f32": round(n_rows * args.d * 4 / 1e9, 2),
        "d": args.d, "m": args.m, "k": 2 ** args.bits,
        "iters": args.iters,
        "wire": "bf16" if args.bf16 else "f32",
        "backend": jax.default_backend(),
    }

    with VecsReader(args.path) as reader:
        t0 = time.perf_counter()
        pq = train_pq_streamed(
            jax.random.PRNGKey(0), reader, args.m, args.bits, args.iters,
            batch_size=args.batch, transfer_dtype=transfer,
        )
        wall = time.perf_counter() - t0
    results["train_wall_s"] = round(wall, 1)
    results["rows_per_s_per_iter"] = round(n_rows * args.iters / wall, 1)

    # Device-only rate of the same per-iteration step on a resident
    # batch: the compute ceiling the host link is holding back.  Reuses
    # the exact _stats_step program compiled during training (same batch
    # shape) — no extra compile.
    if on_gpu:
        from reductive_tpu.pq.streamed import _stats_step

        m, k, ds = pq.codebooks.shape
        xd = jax.random.normal(
            jax.random.PRNGKey(1), (args.batch, args.d),
            jnp.bfloat16 if args.bf16 else jnp.float32,
        )
        acc = (
            jnp.zeros((m, k, ds), jnp.float32),
            jnp.zeros((m, k), jnp.float32),
            jnp.zeros((m,), jnp.float32),
        )
        acc = _stats_step(acc, pq.codebooks, None, xd, use_kernel=True)
        jax.block_until_ready(acc)  # warm (already compiled during training)
        iters = 8
        t0 = time.perf_counter()
        for _ in range(iters):
            acc = _stats_step(acc, pq.codebooks, None, xd, use_kernel=True)
        jax.block_until_ready(acc)
        results["device_only_rows_per_s"] = round(
            args.batch * iters / (time.perf_counter() - t0), 1
        )

    if not args.keep:
        os.remove(args.path)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()

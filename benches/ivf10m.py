"""10M x 128 IVF-PQ: build wall time and serving latency/recall.

The build keeps pass 2 fully on device (codes + IVFADC norms only cross
to the host, ~200 MB) and sends pass 1's candidate matrix as int32
(~160 MB).  Every entry point runs with its default ``use_kernel``.

Usage: python benches/ivf10m.py [--n 10000000] [--cells 4096]
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse
import json
import time

import numpy as np

import jax
import jax.numpy as jnp


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--cells", type=int, default=4096)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    from reductive_tpu.ivf import build_ivf, ivf_search, train_ivf_pq
    from reductive_tpu import train_pq_chunked
    from reductive_tpu.dispatch import encode, use_kernel
    from reductive_tpu.search import search
    from reductive_tpu.utils import enable_compile_cache

    enable_compile_cache()
    n, C, d, m, bits, nq = args.n, args.cells, 128, 16, 8, 16

    # Clustered corpus generated on device (no host link involved).
    kc, kn, kx, kq, kt = jax.random.split(jax.random.PRNGKey(11), 5)
    centers = jax.random.normal(kc, (C, d), dtype=jnp.float32) * 3.0
    member = jax.random.randint(kn, (n,), 0, C)
    x = jnp.take(centers, member, axis=0) + 0.3 * jax.random.normal(
        kx, (n, d), dtype=jnp.float32
    )
    x.block_until_ready()
    queries = x[:: n // nq][:nq] + 0.05 * jax.random.normal(
        kq, (nq, d), dtype=jnp.float32
    )
    results = {}

    t0 = time.perf_counter()
    coarse, rpq = train_ivf_pq(
        jax.random.PRNGKey(13), x, C, m, bits,
        coarse_iterations=8, pq_iterations=8,
    )
    # Drain the async queue so training compute is not attributed to the
    # build phase.
    jax.block_until_ready((coarse, rpq.codebooks))
    results["train_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    index = build_ivf(coarse, rpq, x, capacity="auto")
    results["build_s"] = round(time.perf_counter() - t0, 1)
    results["capacity"] = index.capacity
    results["n_cells"] = C
    results["dropped"] = int(index.dropped_ids.size)

    # Exhaustive ADC baseline (flat PQ, matched bytes).
    flat_pq = train_pq_chunked(kt, x[:262_144], m, bits, 8)
    codes = encode(flat_pq.codebooks, x, use_kernel=use_kernel("encode"))

    def timeit(fn, iters=5):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(iters):
            r = fn()
        jax.block_until_ready(r)
        return (time.perf_counter() - t0) / iters

    true1 = np.asarray(member[:: n // nq][:nq])  # planted cluster, not used
    # 1-recall@10 of the planted nearest neighbor (the row each query was
    # perturbed from), matching the r2 protocol.
    planted = np.arange(0, n, n // nq)[:nq]

    dt_ex = timeit(lambda: search(flat_pq, queries, codes, top_k=10)[1])
    i_ex = np.asarray(search(flat_pq, queries, codes, top_k=10)[1])
    results["exhaustive_adc_ms"] = round(dt_ex * 1e3, 1)
    results["exhaustive_1recall10"] = round(
        float(np.mean([planted[q] in i_ex[q] for q in range(nq)])), 3
    )
    for nprobe in (8, 32):
        dt = timeit(lambda: ivf_search(index, queries, top_k=10,
                                       nprobe=nprobe)[1])
        ii = np.asarray(ivf_search(index, queries, top_k=10, nprobe=nprobe)[1])
        results[f"ivf_nprobe{nprobe}_ms"] = round(dt * 1e3, 1)
        results[f"ivf_nprobe{nprobe}_1recall10"] = round(
            float(np.mean([planted[q] in ii[q] for q in range(nq)])), 3
        )
        results[f"ivf_nprobe{nprobe}_speedup"] = round(dt_ex / dt, 1)

    print(json.dumps(results), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()

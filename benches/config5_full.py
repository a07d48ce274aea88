"""BASELINE config #5 executed at full scale on one card.

Config #5 is "multi-host streaming encode + ADC search: 100M 768-d
vectors" (BASELINE.json).  A 100M x 768 f32 corpus is ~307 GB — it cannot
exist in device memory, and feeding it over a host link makes the run
link-bound.  This bench removes the wire from the equation with the
device-resident
virtual corpus (:class:`reductive_tpu.SyntheticReader` — every row a pure
function of its index, generated on device, never materialized): the
production streaming code paths run end to end at device rate on the
literal config-#5 shape (m=24, k=256, d=768, n >= 100M).

Phases (each timed up to ``jax.block_until_ready``):

1. ``train``      — PQ training on a device-resident sample (the standard
                    corpus-scale practice: train on a sample, encode all).
2. ``generate``   — one full generation pass alone (the synthetic-source
                    overhead, reported so encode can be read net of it).
3. ``encode``     — generate + encode of every corpus row (the GPU
                    kernel on a GPU); codes stay on device ((n, 24) u8
                    ~ 2.5 GB).
4. ``adc_search`` — streamed ADC top-10 over all n codes, 128 queries.
5. ``refine``     — two-stage search: ADC shortlist + exact re-scoring
                    against the virtual corpus (reader-backed refine).
6. ``train_streamed`` (``--full-train``) — a few Lloyd's iterations of
                    the >HBM streamed trainer over the full corpus.

Usage:
    python benches/config5_full.py                 # ~104.9M rows
    python benches/config5_full.py --scale 0.1     # 10.5M-row rehearsal
    python benches/config5_full.py --full-train --iters 2
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse
import json
import time

import jax
import jax.numpy as jnp

from reductive_tpu import SyntheticReader, train_pq_chunked
from reductive_tpu.dispatch import encode, use_kernel
from reductive_tpu.search import search
from reductive_tpu.utils import enable_compile_cache

D, M, BITS, K = 768, 24, 8, 256


def sync() -> None:
    """Drain queued device work: a tiny computation queued behind it."""
    (jnp.zeros(()) + 1).block_until_ready()


def encode_batch(codebooks, x):
    """The encode kernel on a GPU; the einsum elsewhere (CPU smoke runs)."""
    return encode(codebooks, x, dtype=jnp.uint8, use_kernel=use_kernel("encode"))


def main() -> None:
    enable_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--scale", type=float, default=1.0,
                   help="corpus = scale * 100 * 2^20 rows")
    p.add_argument("--sample", type=int, default=1 << 19,
                   help="training sample rows")
    p.add_argument("--train-iters", type=int, default=15)
    p.add_argument("--full-train", action="store_true",
                   help="also run the streamed trainer over the full corpus")
    p.add_argument("--iters", type=int, default=2,
                   help="streamed-trainer iterations (--full-train)")
    p.add_argument("--nq", type=int, default=128)
    p.add_argument("--batch", type=int, default=1 << 20)
    p.add_argument("--out", default="benches/config5_full_results.json")
    args = p.parse_args()

    BATCH = args.batch
    n = max(1, round(args.scale * 100)) * BATCH
    r = SyntheticReader(n, D, seed=0, n_centers=1024, center_scale=2.0)
    results: dict = {
        "config": {"n": n, "d": D, "m": M, "k": K, "batch": BATCH,
                   "backend": jax.default_backend(),
                   "device": str(jax.devices()[0])},
    }
    print(f"config5_full: n={n} ({n * D * 4 / 1e9:.0f} GB virtual), "
          f"d={D}, m={M}, k={K}", flush=True)

    # -- 1. train on a device-resident sample --------------------------------
    sample = r.read(0, args.sample)
    sync()
    t0 = time.perf_counter()
    pq = train_pq_chunked(
        jax.random.PRNGKey(42), sample, M, BITS, args.train_iters,
        chunk=min(1 << 18, args.sample),
    )
    jax.block_until_ready(pq.codebooks)
    dt = time.perf_counter() - t0
    results["train"] = {
        "rows": args.sample, "iters": args.train_iters, "s": round(dt, 2),
        "rows_per_s_per_iter": round(args.sample * args.train_iters / dt),
    }
    print(f"train: {dt:.1f}s ({results['train']['rows_per_s_per_iter']:,} "
          f"rows/s/iter)", flush=True)
    del sample

    # -- 2. generation-only pass ---------------------------------------------
    t0 = time.perf_counter()
    acc = jnp.zeros((), jnp.float32)
    for _, batch in r.batches(BATCH):
        acc += batch[0, 0]
    jax.block_until_ready(acc)
    dt_gen = time.perf_counter() - t0
    results["generate"] = {
        "rows": n, "s": round(dt_gen, 2),
        "rows_per_s": round(n / dt_gen),
    }
    print(f"generate: {dt_gen:.1f}s ({n / dt_gen / 1e6:.1f}M rows/s)",
          flush=True)

    # -- 2b. device-resident encode rate at this shape ------------------------
    # The kernel's own rate, measured on a resident slice.  This is the
    # only valid way to quote encode "net of generation": subtracting the
    # generation-only pass time from the combined pass mixes different
    # sync/dispatch patterns and can report a rate above the device's
    # roofline.
    n_res = min(n, 2 * BATCH)
    xs_res = r.read(0, n_res)
    jax.block_until_ready(xs_res)
    c_res = encode_batch(pq.codebooks, xs_res)  # warm (compile)
    jax.block_until_ready(c_res)
    t0 = time.perf_counter()
    for _ in range(3):
        c_res = encode_batch(pq.codebooks, xs_res)
    jax.block_until_ready(c_res)
    dt_res = (time.perf_counter() - t0) / 3
    results["encode_device_resident"] = {
        "rows": n_res, "s": round(dt_res, 4),
        "rows_per_s": round(n_res / dt_res),
    }
    print(f"encode_device_resident: {n_res / dt_res / 1e6:.1f}M vec/s "
          f"({n_res} rows)", flush=True)
    del xs_res, c_res

    # -- 3. generate + encode the full corpus; codes stay on device ----------
    # Preallocated output + donated in-place writes: holding per-batch code
    # chunks and concatenating at the end doubles the 2.5 GB codes buffer
    # and fragments device memory next to the 3.2 GB generation
    # transients.
    import functools

    @functools.partial(jax.jit, donate_argnums=(0,))
    def write_at(buf, off, vals):
        return jax.lax.dynamic_update_slice(buf, vals, (off, 0))

    t0 = time.perf_counter()
    codes = jnp.zeros((n, M), jnp.uint8)
    for i, (off, batch) in enumerate(r.batches(BATCH)):
        codes = write_at(codes, jnp.int32(off), encode_batch(pq.codebooks, batch))
        # Bound the async-dispatch depth: the host loop otherwise races
        # ~4 batches ahead of the device, keeping 4 x 3.2 GB generation
        # transients live next to the 2.5 GB codes buffer (measured
        # RESOURCE_EXHAUSTED at n=104.9M even with the donated write).
        if i % 2 == 1:
            jax.block_until_ready(codes)
    jax.block_until_ready(codes)
    dt = time.perf_counter() - t0
    results["encode"] = {
        "rows": n, "s": round(dt, 2), "rows_per_s": round(n / dt),
        "codes_gb": round(codes.size / 1e9, 2),
    }
    print(f"encode: {dt:.1f}s ({n / dt / 1e6:.1f}M vec/s incl. generation; "
          f"resident-slice kernel rate in encode_device_resident)",
          flush=True)

    # -- 4. streamed ADC search over all n codes -----------------------------
    qidx = jax.random.randint(jax.random.PRNGKey(9), (args.nq,), 0, n)
    queries = r.read_rows(qidx) + 0.1 * jax.random.normal(
        jax.random.PRNGKey(10), (args.nq, D), jnp.float32)
    sync()
    # Streaming chunk: the library's nq-aware default (bounds the
    # per-chunk score transient; an explicit 1M chunk OOM'd at nq=128
    # next to the resident 2.5 GB codes).
    t0 = time.perf_counter()
    dists, idx = search(pq, queries, codes, 10)
    jax.block_until_ready(idx)
    dt = time.perf_counter() - t0
    hit = float(jnp.mean(jnp.any(idx == qidx[:, None], axis=1)))
    results["adc_search"] = {
        "nq": args.nq, "corpus": n, "s": round(dt, 3),
        "pairs_per_s": round(args.nq * n / dt),
        "self_recall_at_10": round(hit, 4),
    }
    print(f"adc_search: {dt:.2f}s ({args.nq * n / dt / 1e9:.2f}G pairs/s), "
          f"self-recall@10 {hit:.3f}", flush=True)

    # -- 5. two-stage refine against the virtual corpus ----------------------
    t0 = time.perf_counter()
    dists_r, idx_r = search(pq, queries, codes, 10,
                            refine_with=r, refine_factor=4)
    jax.block_until_ready(idx_r)
    dt = time.perf_counter() - t0
    hit_r = float(jnp.mean(jnp.any(idx_r == qidx[:, None], axis=1)))
    results["refine"] = {
        "nq": args.nq, "s": round(dt, 3),
        "self_recall_at_10": round(hit_r, 4),
    }
    print(f"refine: {dt:.2f}s, self-recall@10 {hit_r:.3f}", flush=True)

    # -- 6. optional: streamed training over the full corpus -----------------
    if args.full_train:
        from reductive_tpu import train_pq_streamed

        del codes
        t0 = time.perf_counter()
        pq_full = train_pq_streamed(
            jax.random.PRNGKey(42), r, M, BITS, args.iters,
            batch_size=BATCH,
        )
        jax.block_until_ready(pq_full.codebooks)
        dt = time.perf_counter() - t0
        results["train_streamed"] = {
            "rows": n, "iters": args.iters, "s": round(dt, 2),
            "rows_per_s_per_iter": round(n * args.iters / dt),
        }
        print(f"train_streamed: {dt:.1f}s "
              f"({n * args.iters / dt / 1e6:.2f}M rows/s/iter)", flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()

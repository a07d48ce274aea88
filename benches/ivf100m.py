"""IVF-PQ serving at the flagship config-#5 scale: 104.9M x 768 on one card.

``benches/config5_full.py`` runs config #5 (BASELINE.json: "multi-host
streaming encode + ADC search: 100M 768-d vectors") end to end with
EXHAUSTIVE streamed ADC.  This bench builds an IVF-PQ index over the same
device-resident virtual corpus (:class:`reductive_tpu.SyntheticReader`,
seed 0 — identical rows to ``benches/config5_full.py``) and serves the
same queries in milliseconds: the step from "we ran config #5" to "we
serve config #5".

Phases (each timed up to ``jax.block_until_ready``):

1. ``train``  — two-stage training (k-means++ coarse cells + residual PQ)
                on a device-resident sample.
2. ``build``  — :func:`build_ivf` with ``placement="device"``: placement,
                slot assignment, and the cell scatter never leave the
                device (the host path would ship ~2.5 GB of codes to the
                host and back).
3. ``ground_truth`` — EXACT top-10 neighbors of 128 queries by a streamed
                f32 scan of all n rows (the recall base; also the
                "exhaustive" latency column).
4. ``search`` — warm ``ivf_search`` latency + recall at several nprobe,
                plus a reader-backed exact ``refine`` row.

Memory at n=104.9M, C=16384, L=auto(1.25x)=8000, m=24: cells 3.15 GB u8 +
ids 0.52 GB + norms 0.52 GB + coarse 50 MB — the index serves a 307 GB
f32 corpus from ~4.2 GB of device memory.

Usage:
    python benches/ivf100m.py                  # full 104.9M
    python benches/ivf100m.py --scale 0.1      # 10.5M rehearsal
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from reductive_tpu import SyntheticReader
from reductive_tpu.ivf import build_ivf, ivf_search, train_ivf_pq
from reductive_tpu.utils import enable_compile_cache

D, M, BITS = 768, 24, 8


def sync() -> None:
    """Drain queued device work: a tiny computation queued behind it."""
    (jnp.zeros(()) + 1).block_until_ready()


@functools.partial(jax.jit, donate_argnums=(2, 3))
def _gt_merge(q, xb, best_d, best_i, off):
    """Merge one corpus batch into the running exact top-10."""
    from reductive_tpu.linalg import squared_euclidean_distance

    d2 = squared_euclidean_distance(q, xb)  # (nq, b) f32 highest
    neg, idx = jax.lax.top_k(-d2, best_d.shape[1])
    cat_d = jnp.concatenate([best_d, -neg], axis=1)
    cat_i = jnp.concatenate([best_i, idx.astype(jnp.int64) + off], axis=1)
    neg2, sel = jax.lax.top_k(-cat_d, best_d.shape[1])
    return -neg2, jnp.take_along_axis(cat_i, sel, axis=1)


def exact_ground_truth(reader, queries, batch, top_k=10):
    nq = queries.shape[0]
    best_d = jnp.full((nq, top_k), jnp.inf, jnp.float32)
    best_i = jnp.full((nq, top_k), -1, jnp.int64)
    for i, (off, xb) in enumerate(reader.batches(batch)):
        best_d, best_i = _gt_merge(queries, xb, best_d, best_i,
                                   jnp.int64(off))
        if i % 2 == 1:
            jax.block_until_ready(best_d)
    jax.block_until_ready(best_i)
    return np.asarray(best_d), np.asarray(best_i)


def main() -> None:
    enable_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--scale", type=float, default=1.0,
                   help="corpus = scale * 100 * 2^20 rows")
    p.add_argument("--cells", type=int, default=16384)
    p.add_argument("--sample", type=int, default=1 << 19)
    p.add_argument("--nq", type=int, default=128)
    p.add_argument("--batch", type=int, default=1 << 20)
    p.add_argument("--out", default="benches/ivf100m_results.json")
    args = p.parse_args()

    n = max(1, round(args.scale * 100)) * (1 << 20)
    # Scale the cell count with the corpus so a rehearsal keeps the
    # full run's mean cell size (~6400) — a fixed C at 0.1 scale makes
    # cells 10x larger and the probe shapes unrepresentative.
    C = args.cells if args.scale >= 1 else max(
        512, 1 << int(np.log2(args.cells * args.scale))
    )
    r = SyntheticReader(n, D, seed=0, n_centers=1024, center_scale=2.0)
    results: dict = {
        "config": {"n": n, "d": D, "m": M, "k": 2 ** BITS, "cells": C,
                   "backend": jax.default_backend(),
                   "device": str(jax.devices()[0])},
    }
    print(f"ivf100m: n={n} ({n * D * 4 / 1e9:.0f} GB virtual), d={D}, "
          f"m={M}, C={C}", flush=True)

    # -- 1. train the two quantization stages on a sample --------------------
    sync()
    t0 = time.perf_counter()
    # Chunk sized so the coarse stage's (chunk, C) transients stay
    # ~0.5 GB where the einsum path runs.
    coarse, pq = train_ivf_pq(
        jax.random.PRNGKey(42), r, C, M, BITS,
        train_sample=min(args.sample, n // 2),
        chunk=min(1 << 17, max(8192, (1 << 27) // C)),
    )
    jax.block_until_ready(pq.codebooks)
    dt = time.perf_counter() - t0
    results["train"] = {"rows": min(args.sample, n // 2), "s": round(dt, 1)}
    print(f"train: {dt:.1f}s", flush=True)

    # -- 2. device-side build over the full corpus ----------------------------
    t0 = time.perf_counter()
    index = build_ivf(coarse, pq, r, capacity="auto", placement="device",
                      batch=args.batch)
    jax.block_until_ready(index.cell_norms)
    dt_build = time.perf_counter() - t0
    util = float(jnp.mean(index.cell_ids >= 0))
    results["build"] = {
        "rows": n, "s": round(dt_build, 1),
        "rows_per_s": round(n / dt_build),
        "capacity": index.capacity, "dropped": int(index.dropped_ids.size),
        "cell_util": round(util, 4),
        "index_gb": round(
            (index.cell_codes.size + 4 * index.cell_ids.size
             + 4 * index.cell_norms.size + 4 * index.coarse_centroids.size)
            / 1e9, 2,
        ),
    }
    print(f"build: {dt_build:.1f}s ({n / dt_build / 1e6:.1f}M rows/s), "
          f"L={index.capacity}, dropped={index.dropped_ids.size}",
          flush=True)

    # -- 3. exact ground truth by streamed f32 scan ---------------------------
    qidx = np.asarray(
        jax.random.randint(jax.random.PRNGKey(9), (args.nq,), 0, n)
    ).astype(np.int64)
    queries = r.read_rows(qidx) + 0.1 * jax.random.normal(
        jax.random.PRNGKey(10), (args.nq, D), jnp.float32)
    jax.block_until_ready(queries)
    t0 = time.perf_counter()
    gt_d, gt_i = exact_ground_truth(r, queries, args.batch)
    dt_gt = time.perf_counter() - t0
    results["ground_truth"] = {
        "nq": args.nq, "s": round(dt_gt, 2),
        "pairs_per_s": round(args.nq * n / dt_gt),
    }
    print(f"ground_truth (exact streamed scan): {dt_gt:.1f}s "
          f"({args.nq * n / dt_gt / 1e9:.2f}G exact pairs/s)", flush=True)

    # -- 4. IVF search: latency + recall ladder -------------------------------
    def recalls(ids):
        ids = np.asarray(ids)
        r10 = float(np.mean([
            len(set(ids[q].tolist()) & set(gt_i[q].tolist())) / 10.0
            for q in range(args.nq)
        ]))
        r1 = float(np.mean([gt_i[q, 0] in ids[q] for q in range(args.nq)]))
        return round(r10, 4), round(r1, 4)

    results["search"] = {}
    for nprobe in (8, 32, 64):
        _, ids = ivf_search(index, queries, top_k=10, nprobe=nprobe)
        jax.block_until_ready(ids)  # warm + compile
        t0 = time.perf_counter()
        iters = 4
        for _ in range(iters):
            _, ids = ivf_search(index, queries, top_k=10, nprobe=nprobe)
        jax.block_until_ready(ids)
        dt = (time.perf_counter() - t0) / iters
        r10, r1 = recalls(ids)
        results["search"][f"nprobe{nprobe}"] = {
            "ms": round(dt * 1e3, 1), "recall_at_10": r10,
            "one_recall_at_10": r1,
            "speedup_vs_exact": round(dt_gt / dt, 1),
        }
        print(f"ivf nprobe={nprobe}: {dt * 1e3:.1f} ms, recall@10 {r10}, "
              f"1-recall@10 {r1} ({dt_gt / dt:.0f}x vs exact scan)",
              flush=True)

    # Reader-backed exact refine on top of the widest probe.
    _, ids = ivf_search(index, queries, top_k=10, nprobe=32,
                        refine_with=r, refine_factor=4)
    jax.block_until_ready(ids)
    t0 = time.perf_counter()
    for _ in range(2):
        _, ids = ivf_search(index, queries, top_k=10, nprobe=32,
                            refine_with=r, refine_factor=4)
    jax.block_until_ready(ids)
    dt = (time.perf_counter() - t0) / 2
    r10, r1 = recalls(ids)
    results["search"]["nprobe32_refine4"] = {
        "ms": round(dt * 1e3, 1), "recall_at_10": r10,
        "one_recall_at_10": r1,
        "speedup_vs_exact": round(dt_gt / dt, 1),
    }
    print(f"ivf nprobe=32 + refine x4: {dt * 1e3:.1f} ms, recall@10 {r10}, "
          f"1-recall@10 {r1}", flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()

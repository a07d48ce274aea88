"""Dynamic-update throughput of the 10M x 128 IVF-PQ index.

Measures `ivf_add`/`ivf_remove` rates at the 10M scale on one card, and
proof that the compiled search
program's latency and recall are unchanged by updates (static cell
shapes mean the search executable is literally the same one).

Phases:

1. build        — train + build the 10M index (same corpus recipe as
                  benches/ivf10m.py).
2. search_pre   — compiled `ivf_search` latency + planted 1-recall@10.
3. remove       — `ivf_remove` of 100k random live ids.
4. add          — `ivf_add` of the same 100k rows back (copy-on-write),
                  reported as rows/s.
5. add_donated  — remove + re-add with `donate=True` (in-place scatter).
6. churn        — sustained alternating remove/add of 100k-row batches
                  (donated), steady-state updates/s.
7. search_post  — same compiled search after all updates: latency and
                  recall must match phase 2.

Usage: python benches/ivf_update.py [--n 10000000] [--cells 4096]
       [--upd 100000] [--churn-rounds 4]
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
    ap.add_argument("--upd", type=int, default=100_000)
    ap.add_argument("--churn-rounds", type=int, default=4)
    ap.add_argument("--out", type=str, default="benches/ivf_update_results.json")
    args = ap.parse_args()

    from reductive_tpu.ivf import (
        build_ivf, ivf_add, ivf_remove, ivf_search, train_ivf_pq,
    )

    from reductive_tpu.utils import enable_compile_cache

    enable_compile_cache()
    n, C, d, m, bits, nq = args.n, args.cells, 128, 16, 8, 16
    U = args.upd

    kc, kn, kx, kq = jax.random.split(jax.random.PRNGKey(11), 4)
    centers = jax.random.normal(kc, (C, d), dtype=jnp.float32) * 3.0
    member = jax.random.randint(kn, (n,), 0, C)
    x = jnp.take(centers, member, axis=0) + 0.3 * jax.random.normal(
        kx, (n, d), dtype=jnp.float32
    )
    x.block_until_ready()
    queries = x[:: n // nq][:nq] + 0.05 * jax.random.normal(
        kq, (nq, d), dtype=jnp.float32
    )
    planted = np.arange(0, n, n // nq)[:nq]
    results: dict = {"n": n, "cells": C, "update_rows": U}

    t0 = time.perf_counter()
    coarse, rpq = train_ivf_pq(
        jax.random.PRNGKey(13), x, C, m, bits,
        coarse_iterations=8, pq_iterations=8,
    )
    jax.block_until_ready((coarse, rpq.codebooks))
    index = build_ivf(coarse, rpq, x, capacity="auto")
    results["build_s"] = round(time.perf_counter() - t0, 1)
    results["capacity"] = index.capacity

    def timeit(fn, iters=5):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(iters):
            r = fn()
        jax.block_until_ready(r)
        return (time.perf_counter() - t0) / iters

    def recall(idx_arr):
        ii = np.asarray(idx_arr)
        return float(np.mean([planted[q] in ii[q] for q in range(nq)]))

    nprobe = 8
    dt = timeit(lambda: ivf_search(index, queries, top_k=10, nprobe=nprobe))
    ids_pre = np.asarray(ivf_search(index, queries, top_k=10, nprobe=nprobe)[1])
    results["search_pre"] = {
        "ms": round(dt * 1e3, 2), "recall10": round(recall(ids_pre), 3),
    }
    print(f"build {results['build_s']}s; search_pre "
          f"{results['search_pre']}", flush=True)

    # Rows to churn: a contiguous id block away from the planted queries
    # (updates must not change what the queries should find).
    rng = np.random.default_rng(5)
    upd_ids = rng.choice(
        np.setdiff1d(np.arange(n, dtype=np.int64), planted),
        size=U, replace=False,
    )
    upd_rows = jnp.take(x, jnp.asarray(upd_ids.astype(np.int32)), axis=0)
    upd_rows.block_until_ready()

    # -- remove -------------------------------------------------------------
    t0 = time.perf_counter()
    idx2 = ivf_remove(index, upd_ids)
    idx2.cell_ids.block_until_ready()
    dt = time.perf_counter() - t0
    results["remove"] = {"s": round(dt, 3), "rows_per_s": round(U / dt)}
    print(f"remove: {results['remove']}", flush=True)

    # -- add (copy-on-write) --------------------------------------------------
    t0 = time.perf_counter()
    idx3 = ivf_add(idx2, upd_rows, ids=upd_ids)
    idx3.cell_ids.block_until_ready()
    dt = time.perf_counter() - t0
    results["add"] = {"s": round(dt, 3), "rows_per_s": round(U / dt)}
    print(f"add: {results['add']}", flush=True)

    # -- remove + add, donated ------------------------------------------------
    t0 = time.perf_counter()
    idx4 = ivf_remove(idx3, upd_ids)
    idx4 = ivf_add(idx4, upd_rows, ids=upd_ids, donate=True)
    idx4.cell_ids.block_until_ready()
    dt = time.perf_counter() - t0
    results["remove_add_donated"] = {
        "s": round(dt, 3), "rows_per_s": round(U / dt),
    }
    print(f"remove+add donated: {results['remove_add_donated']}", flush=True)

    # -- sustained churn --------------------------------------------------------
    t0 = time.perf_counter()
    cur = idx4
    for _ in range(args.churn_rounds):
        cur = ivf_remove(cur, upd_ids)
        cur = ivf_add(cur, upd_rows, ids=upd_ids, donate=True)
    cur.cell_ids.block_until_ready()
    dt = time.perf_counter() - t0
    results["churn"] = {
        "rounds": args.churn_rounds, "s": round(dt, 3),
        "updates_per_s": round(args.churn_rounds * U / dt),
    }
    print(f"churn: {results['churn']}", flush=True)

    # -- search after updates ----------------------------------------------------
    dt = timeit(lambda: ivf_search(cur, queries, top_k=10, nprobe=nprobe))
    ids_post = np.asarray(ivf_search(cur, queries, top_k=10, nprobe=nprobe)[1])
    results["search_post"] = {
        "ms": round(dt * 1e3, 2), "recall10": round(recall(ids_post), 3),
    }
    # The updated ids were chosen away from the planted neighbors, so the
    # top-10 sets must be identical, not merely similar.
    results["search_post"]["identical_to_pre"] = bool(
        np.array_equal(np.sort(ids_pre, axis=1), np.sort(ids_post, axis=1))
    )
    print(f"search_post: {results['search_post']}", flush=True)

    print(json.dumps(results), flush=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()

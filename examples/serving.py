"""Serving-side lifecycle: load → search (L2 + MIPS) → update → scale out.

The training-side lifecycle (train → persist → stream-encode → index)
lives in ``examples/pipeline.py``; this example is the other half — what
a query-serving process does:

1. build (or load) an IVF-PQ index artifact,
2. answer L2 queries (IVF + exact refine),
3. answer cosine/MIPS queries over the same index (``metric="dot"``),
4. apply live updates (``ivf_add`` / ``ivf_remove``) without re-tracing
   compiled search programs,
5. fan the exhaustive scan out over a device mesh (``search_sharded``)
   when one card's scan rate isn't enough.

Run: ``python examples/serving.py [--n 100000] [--cells 256]``
(CPU-safe at small sizes: ``--n 20000 --cells 64``.)
"""

from __future__ import annotations

import argparse
import time

import numpy as np

import jax
import jax.numpy as jnp


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--cells", type=int, default=256)
    ap.add_argument("--queries", type=int, default=16)
    args = ap.parse_args()

    from reductive_tpu.ivf import (
        build_ivf, ivf_add, ivf_remove, ivf_search, train_ivf_pq,
    )
    from reductive_tpu.search import search, search_sharded
    from reductive_tpu.utils import enable_compile_cache

    enable_compile_cache()
    # use_kernel stays at its default everywhere: the library runs the GPU
    # kernels on a GPU and plain XLA elsewhere (reductive_tpu.dispatch).
    print(f"platform: {jax.devices()[0].platform}")

    # Corpus on the unit sphere: the cosine-serving regime (dot == cos).
    key = jax.random.PRNGKey(0)
    kx, kq = jax.random.split(key)
    x = jax.random.normal(kx, (args.n, args.d), dtype=jnp.float32)
    x = x / jnp.linalg.norm(x, axis=1, keepdims=True)
    queries = x[:: args.n // args.queries][: args.queries]

    # 1. index (a real deployment loads this via reductive_tpu.io.load).
    t0 = time.perf_counter()
    coarse, rpq = train_ivf_pq(
        jax.random.PRNGKey(1), x, args.cells, args.m, args.bits,
    )
    index = build_ivf(coarse, rpq, x, capacity="auto")
    print(f"index: {args.cells} cells, capacity {index.capacity}, "
          f"built in {time.perf_counter() - t0:.1f}s (incl compile)")

    # 2. L2 serving: IVF shortlist + exact refine.
    t0 = time.perf_counter()
    _, ids_l2 = ivf_search(index, queries, top_k=10, nprobe=8, refine_with=x)
    print(f"L2 IVF+refine: {1e3 * (time.perf_counter() - t0):.1f} ms "
          f"(top-1 self-hit "
          f"{float(np.mean(np.asarray(ids_l2)[:, 0] == np.arange(0, args.n, args.n // args.queries)[:args.queries])):.2f})")

    # 3. The same index serves cosine/MIPS queries.
    t0 = time.perf_counter()
    _, ids_ip = ivf_search(index, queries, top_k=10, nprobe=8,
                           metric="dot", refine_with=x)
    print(f"MIPS IVF+refine: {1e3 * (time.perf_counter() - t0):.1f} ms "
          f"(agrees with L2 top-1 on the sphere: "
          f"{float(np.mean(np.asarray(ids_ip)[:, 0] == np.asarray(ids_l2)[:, 0])):.2f})")

    # 4. Live updates: retire the first 1000 rows, add 1000 fresh ones.
    kn = jax.random.PRNGKey(2)
    x_new = jax.random.normal(kn, (1000, args.d), dtype=jnp.float32)
    x_new = x_new / jnp.linalg.norm(x_new, axis=1, keepdims=True)
    t0 = time.perf_counter()
    index = ivf_remove(index, np.arange(1000))
    index = ivf_add(index, x_new)
    print(f"update: -1000/+1000 rows in "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms "
          f"({int((np.asarray(index.cell_ids) >= 0).sum())} live)")
    _, ids_upd = ivf_search(index, x_new[:4], top_k=3, nprobe=8)
    new_id0 = args.n
    print(f"update: new rows retrievable: "
          f"{float(np.mean(np.asarray(ids_upd)[:, 0] >= new_id0)):.2f}")

    # 5. Scale-out: corpus-sharded exhaustive scan over a mesh (here all
    # local devices; across the cards of a host the merge rides NVLink).  The exhaustive
    # scan quantizes FULL vectors, so it needs a flat PQ trained on the
    # corpus — the IVF residual quantizer's codebooks span the
    # centroid-subtracted residual distribution and would mis-scale raw
    # rows.
    n_dev = len(jax.devices())
    if n_dev > 1:
        from reductive_tpu import train_pq_chunked
        from reductive_tpu.parallel import make_mesh

        flat_pq = train_pq_chunked(
            jax.random.PRNGKey(3), x, args.m, args.bits, 8,
        )
        codes = flat_pq.quantize_batch(x, dtype=jnp.uint8)
        shards = max(s for s in range(1, n_dev + 1) if args.n % s == 0)
        mesh = make_mesh((shards,), ("data",), devices=jax.devices()[:shards])
        t0 = time.perf_counter()
        _, ids_sh = search_sharded(flat_pq, queries, codes, top_k=10,
                                   mesh=mesh, metric="dot")
        _, ids_1 = search(flat_pq, queries, codes, top_k=10, metric="dot")
        agree = float(np.mean([
            len(set(np.asarray(ids_sh)[q].tolist())
                & set(np.asarray(ids_1)[q].tolist())) / 10
            for q in range(args.queries)
        ]))
        print(f"sharded exhaustive scan over {shards} devices: "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms, "
              f"agreement with single-device: {agree:.2f}")
    else:
        print("sharded scan: skipped (single device)")


if __name__ == "__main__":
    main()

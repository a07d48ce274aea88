"""End-to-end production pipeline: train → persist → stream-encode → search.

A template for the full serving lifecycle on one GPU host:

1. generate (or mmap) an fvecs corpus through the native IO runtime;
2. train an optimized product quantizer at corpus scale (chunked
   trainers — nothing O(n * k) ever materializes);
3. persist the codebook artifact and reload it;
4. stream-encode the corpus from disk through the fused encode kernel
   (native prefetch executor overlapping IO / conversion / compute);
5. answer top-k queries by ADC over the compressed codes.

Run:  python examples/pipeline.py [--n 200000] [--d 128] [--opq]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--opq", action="store_true", help="train OPQ instead of PQ")
    ap.add_argument("--ivf", type=int, default=0, metavar="N_CELLS",
                    help="also build an IVF-PQ index with N_CELLS coarse "
                         "cells and compare against the exhaustive search")
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--disk", action="store_true",
                    help="also run the fully disk-resident lifecycle "
                         "(streamed training, IVF build from the reader, "
                         "exact refine from the reader) — the >HBM path")
    ap.add_argument("--virtual", action="store_true",
                    help="also run the wire-free lifecycle from a "
                         "device-resident virtual corpus (SyntheticReader) "
                         "— streamed train, encode, search, exact refine, "
                         "no disk or host link in the loop")
    args = ap.parse_args()

    from reductive_tpu import io, train_opq_chunked, train_pq_chunked
    from reductive_tpu.data import stream_encode
    from reductive_tpu.dispatch import use_kernel
    from reductive_tpu.utils import enable_compile_cache
    from reductive_tpu.native import VecsReader, write_fvecs
    from reductive_tpu.search import search

    enable_compile_cache()
    # Every entry point below leaves use_kernel at its default, so the
    # library picks the GPU kernels on a GPU and plain XLA elsewhere.
    print(f"platform: {jax.devices()[0].platform}")

    with tempfile.TemporaryDirectory() as td:
        # 1. corpus on disk (stand-in for SIFT/Deep1B-style data)
        corpus_path = os.path.join(td, "corpus.fvecs")
        rng = np.random.default_rng(0)
        data = rng.standard_normal((args.n, args.d)).astype(np.float32)
        write_fvecs(corpus_path, data)

        # 2. corpus-scale training (encode kernel assigns on a GPU).
        # Long jobs checkpoint every few iterations — a killed run resumes
        # from the artifact via initial_model= (OPQ) losing at most that
        # many alternations.
        key = jax.random.PRNGKey(42)
        train = train_opq_chunked if args.opq else train_pq_chunked
        ckpt = os.path.join(td, "train_ckpt.npz")
        t0 = time.perf_counter()
        pq = train(
            key, jnp.asarray(data), args.m, args.bits, args.iters,
            checkpoint_every=max(2, args.iters // 3), checkpoint_path=ckpt,
        )
        jax.block_until_ready(pq.codebooks)
        print(f"trained {'OPQ' if args.opq else 'PQ'} m={args.m} "
              f"k={2**args.bits} in {time.perf_counter()-t0:.1f}s (incl compile); "
              f"recovery checkpoint at {os.path.basename(ckpt)}")

        # 3. persist + reload the codebook artifact
        artifact = os.path.join(td, "model.npz")
        io.save(artifact, pq)
        pq = io.load(artifact)

        # 4. stream-encode the corpus from disk (native prefetch + kernel)
        t0 = time.perf_counter()
        with VecsReader(corpus_path) as reader:
            codes = stream_encode(pq, reader, batch_size=1 << 15)
        dt = time.perf_counter() - t0
        print(f"encoded {args.n} vectors in {dt:.2f}s "
              f"({args.n/dt/1e6:.1f}M vec/s end-to-end incl IO)")
        print(f"compression: {data.nbytes/1e6:.0f} MB -> {codes.nbytes/1e6:.1f} MB")

        # quality: mean reconstruction error
        sample = jnp.asarray(data[:10_000])
        rec = pq.reconstruct_batch(pq.quantize_batch(sample))
        mse = float(jnp.mean((sample - rec) ** 2))
        print(f"reconstruction MSE (unit-variance data): {mse:.4f}")

        # 5. ADC top-k search over the compressed corpus.  Queries are
        # small perturbations of corpus rows, so each has one planted true
        # near neighbor (isotropic random data has no meaningful neighbors
        # — everything is nearly equidistant in 128-d).
        planted = rng.integers(0, args.n, size=args.queries)
        queries = jnp.asarray(
            data[planted]
            + 0.1 * rng.standard_normal((args.queries, args.d)).astype(np.float32)
        )
        codes_j = jnp.asarray(codes)
        packed = (args.bits <= 4 and args.m % 2 == 0
                  and use_kernel("adc", codes_dtype=jnp.uint8, packed=True))
        if packed:
            # 4-bit codes: pack two per byte and search the packed corpus
            # directly with the ADC kernel (half the code bytes, same
            # scores).
            from reductive_tpu.ops import pack_u4_codes

            codes_j = pack_u4_codes(codes_j)
            print(f"packed u4 codes: {codes.nbytes/1e6:.1f} MB -> "
                  f"{codes_j.nbytes / 1e6:.1f} MB")
        t0 = time.perf_counter()
        dists, idx = search(pq, queries, codes_j, top_k=10, packed=packed)
        jax.block_until_ready(idx)
        dt = time.perf_counter() - t0
        print(f"searched {args.queries} queries x {args.n} vectors in "
              f"{dt*1e3:.0f} ms (incl compile)")

        recall = float(np.mean([
            planted[q] in np.asarray(idx[q]) for q in range(args.queries)
        ]))
        print(f"recall@10 of the planted nearest neighbor: {recall:.2f}")

        # 6. Optional IVF-PQ: prune the scan to nprobe cells of residual
        # codes (residual encoding).
        if args.ivf:
            from reductive_tpu.ivf import build_ivf, ivf_search, train_ivf_pq

            t0 = time.perf_counter()
            coarse, rpq = train_ivf_pq(
                jax.random.PRNGKey(7), jnp.asarray(data), args.ivf,
                args.m, args.bits,
            )
            index = build_ivf(coarse, rpq, jnp.asarray(data), capacity="auto")
            print(f"built IVF index ({args.ivf} cells, capacity "
                  f"{index.capacity}) in {time.perf_counter()-t0:.1f}s")
            t0 = time.perf_counter()
            _, ids = ivf_search(index, queries, top_k=10, nprobe=8)
            jax.block_until_ready(ids)
            print(f"IVF search (nprobe=8) in "
                  f"{(time.perf_counter()-t0)*1e3:.0f} ms (incl compile)")
            recall_ivf = float(np.mean([
                planted[q] in np.asarray(ids[q]) for q in range(args.queries)
            ]))
            print(f"IVF recall@10 of the planted neighbor: {recall_ivf:.2f}")

        # 7. Optional fully disk-resident lifecycle — the path for corpora
        # larger than HBM (BASELINE config #5): training re-streams the
        # corpus from disk each iteration, the IVF build streams it twice,
        # and the exact refine fetches only the candidate rows.  The
        # corpus never resides in device memory.
        if args.disk:
            from reductive_tpu import train_pq_streamed
            from reductive_tpu.ivf import build_ivf, ivf_search, train_ivf_pq

            wire = None  # jnp.bfloat16 halves the host-to-device bytes
            with VecsReader(corpus_path) as reader:
                t0 = time.perf_counter()
                spq = train_pq_streamed(
                    jax.random.PRNGKey(9), reader, args.m, args.bits,
                    max(2, args.iters // 2), batch_size=1 << 15,
                    transfer_dtype=wire,
                )
                rec = spq.reconstruct_batch(spq.quantize_batch(sample))
                smse = float(jnp.mean((sample - rec) ** 2))
                print(f"disk: streamed PQ training in "
                      f"{time.perf_counter()-t0:.1f}s (roundtrip MSE "
                      f"{smse:.4f})")
                cells = args.ivf or 64
                coarse, rpq = train_ivf_pq(
                    jax.random.PRNGKey(10), reader, cells, args.m, args.bits,
                    train_sample=min(args.n - 1, 1 << 17),
                )
                t0 = time.perf_counter()
                index = build_ivf(coarse, rpq, reader, capacity="auto")
                print(f"disk: IVF build from reader in "
                      f"{time.perf_counter()-t0:.1f}s "
                      f"(dropped={index.dropped_ids.size})")
                _, i_r = ivf_search(index, queries, top_k=10, nprobe=8,
                                    refine_with=reader)
                rec_d = float(np.mean([
                    planted[q] in np.asarray(i_r[q])
                    for q in range(args.queries)
                ]))
                print(f"disk: IVF + disk-refine recall@10: {rec_d:.2f}")

        # 8. Optional wire-free lifecycle from a virtual corpus: every row
        # is a pure function of its index, generated on device on demand —
        # the same streaming code paths as --disk with zero host-link
        # traffic (how benches/config5_full.py runs 100M x 768 on one
        # card).
        if args.virtual:
            from reductive_tpu import SyntheticReader, train_pq_streamed

            vr = SyntheticReader(args.n, args.d, seed=1)
            t0 = time.perf_counter()
            vpq = train_pq_streamed(
                jax.random.PRNGKey(11), vr, args.m, args.bits,
                max(2, args.iters // 2), batch_size=1 << 15,
            )
            jax.block_until_ready(vpq.codebooks)
            print(f"virtual: streamed PQ training in "
                  f"{time.perf_counter()-t0:.1f}s")
            t0 = time.perf_counter()
            vcodes = jnp.concatenate([
                vpq.quantize_batch(b)
                for _, b in vr.batches(1 << 15)
            ])
            jax.block_until_ready(vcodes)
            print(f"virtual: encoded {args.n} rows on device in "
                  f"{time.perf_counter()-t0:.1f}s (codes stay in HBM)")
            planted_v = rng.integers(0, args.n, size=args.queries)
            qv = vr.read_rows(planted_v) + 0.1 * jnp.asarray(
                rng.standard_normal((args.queries, args.d)).astype(np.float32)
            )
            _, vi = search(vpq, qv, vcodes, top_k=10, refine_with=vr)
            rec_v = float(np.mean([
                planted_v[q] in np.asarray(vi[q])
                for q in range(args.queries)
            ]))
            print(f"virtual: search + exact-refine recall@10: {rec_v:.2f}")


if __name__ == "__main__":
    main()

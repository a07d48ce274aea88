"""Benchmark suite: the reference's criterion harness shapes plus the
BASELINE.json workload configs, on real hardware.

The reference defines benchmark *shapes* but stores no numbers
(``benches/pq.rs``, ``benches/linalg.rs`` — see BASELINE.md).  This runner
measures the library on those same shapes plus the BASELINE workload
configs, and prints one JSON line per benchmark (plus a summary file when
``--out`` is given).  Every entry point runs with its default
``use_kernel``, so a GPU runs the encode and ADC kernels and other
platforms the plain XLA paths (:mod:`reductive_tpu.dispatch`); kernel-only
rows are skipped where no kernel runs.

Usage:  python benches/run.py [--quick] [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp


def timeit(fn, *args, iters=5):
    """Mean seconds per call after one warm call; each window ends in
    ``jax.block_until_ready`` (no extra device work inside it)."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def encode_all(pq, x):
    """Codes of every row, by the kernel on a GPU and the einsum elsewhere."""
    from reductive_tpu.dispatch import encode, use_kernel

    return jax.jit(lambda c, v: encode(c, v, use_kernel=use_kernel("encode")))(
        pq.codebooks, x)


def kernels_run() -> bool:
    from reductive_tpu.dispatch import use_kernel

    return use_kernel("encode")


RESULTS = []


def record(name, seconds, unit="ms", extra=None):
    value = seconds * 1e3 if unit == "ms" else seconds
    entry = {"bench": name, "value": round(value, 4), "unit": unit}
    if extra:
        entry.update(extra)
    RESULTS.append(entry)
    print(json.dumps(entry))


def bench_linalg(quick):
    """Reference shapes: benches/linalg.rs:8-59."""
    from reductive_tpu.linalg import covariance, squared_euclidean_distance

    key = jax.random.PRNGKey(0)
    a = jax.random.normal(key, (50, 100), dtype=jnp.float32)
    cov = jax.jit(lambda x: covariance(x, 0))
    record("covariance_axis0_50x100", timeit(cov, a))

    a1 = jax.random.normal(key, (100, 50), dtype=jnp.float32)
    cov1 = jax.jit(lambda x: covariance(x, 1))
    record("covariance_axis1_100x50", timeit(cov1, a1))

    u = jax.random.normal(key, (200, 50), dtype=jnp.float32)
    v = jax.random.normal(key, (50, 50), dtype=jnp.float32)
    # ix2_ix2: one matrix x matrix call (benches/linalg.rs:52-59).
    sq = jax.jit(squared_euclidean_distance)
    record("squared_euclidean_distance_200x50_50x50", timeit(sq, u, v))
    # ix1_ix1 / ix1_ix2 (benches/linalg.rs:24-50): the reference loops the
    # vec x vec / vec x mat paths row-by-row on the host; the JAX-idiomatic
    # equivalent vmaps the same single-vector code paths into one dispatch
    # (10,000 / 200 calls' worth of work respectively).
    ix1_ix1 = jax.jit(
        lambda u, v: jax.vmap(
            lambda a: jax.vmap(lambda b: squared_euclidean_distance(a, b))(v)
        )(u)
    )
    record(
        "squared_euclidean_distance_ix1_ix1_200x50_50x50",
        timeit(ix1_ix1, u, v),
        extra={"note": "vec x vec path vmapped over all 10k row pairs"},
    )
    ix1_ix2 = jax.jit(
        lambda u, v: jax.vmap(lambda a: squared_euclidean_distance(a, v))(u)
    )
    record(
        "squared_euclidean_distance_ix1_ix2_200x50_50x50",
        timeit(ix1_ix2, u, v),
        extra={"note": "vec x mat path vmapped over 200 rows"},
    )


def bench_reference_pq_shapes(quick):
    """Reference shapes: benches/pq.rs:8-55 — 100x128, m=16, k=16 (4 bit)."""
    from reductive_tpu.pq import primitives

    key = jax.random.PRNGKey(1)
    kx, kc = jax.random.split(key)
    x = jax.random.normal(kx, (100, 128), dtype=jnp.float32)
    cb = jax.random.normal(kc, (16, 16, 8), dtype=jnp.float32)
    enc = jax.jit(lambda c, x: primitives.quantize_batch(c, x, dtype=jnp.uint8))
    record("pq_quantize_batch_100x128_m16_k16", timeit(enc, cb, x))
    codes = enc(cb, x)
    dec = jax.jit(primitives.reconstruct_batch)
    record("pq_reconstruct_batch_100x16", timeit(dec, cb, codes))

    # One-by-one harnesses (benches/pq.rs:15-25,35-46): the reference
    # loops quantize_vector / reconstruct over rows; here the same
    # single-vector code paths are vmapped into one dispatch.
    enc1 = jax.jit(
        lambda c, x: jax.vmap(lambda v: primitives.quantize(c, v, dtype=jnp.uint8))(x)
    )
    record(
        "pq_quantize_rowwise_100x128_m16_k16", timeit(enc1, cb, x),
        extra={"note": "single-vector quantize path vmapped over 100 rows"},
    )
    dec1 = jax.jit(lambda c, q: jax.vmap(lambda row: primitives.reconstruct(c, row))(q))
    record(
        "pq_reconstruct_rowwise_100x16", timeit(dec1, cb, codes),
        extra={"note": "single-vector reconstruct path vmapped over 100 rows"},
    )


def bench_config1(quick):
    """PQ m=4, k=256 on 10k x 64 Gaussian: train + encode + reconstruct."""
    from reductive_tpu import train_pq

    key = jax.random.PRNGKey(2)
    kx, kt = jax.random.split(key)
    n = 2_000 if quick else 10_000
    x = jax.random.normal(kx, (n, 64), dtype=jnp.float32)

    t0 = time.perf_counter()
    pq = train_pq(kt, x, 4, 8, 10, 1)
    jax.block_until_ready(pq.codebooks)
    record("config1_train_pq_m4_k256_10kx64", time.perf_counter() - t0,
           extra={"note": "includes jit compile"})

    enc = jax.jit(lambda p, x: p.quantize_batch(x))
    codes = enc(pq, x)
    record("config1_encode", timeit(enc, pq, x))
    dec = jax.jit(lambda p, c: p.reconstruct_batch(c))
    record("config1_reconstruct", timeit(dec, pq, codes))
    rec = dec(pq, codes)
    mse = float(jnp.mean((x - rec) ** 2))
    RESULTS.append({"bench": "config1_recon_mse", "value": round(mse, 6), "unit": "mse"})
    print(json.dumps(RESULTS[-1]))


def bench_config2(quick):
    """PQ m=16, k=256 on 1M SIFT-style 128-d vectors: the headline encode."""
    from reductive_tpu import Pq
    from reductive_tpu.pq import primitives

    key = jax.random.PRNGKey(3)
    kx, kc = jax.random.split(key)
    n = 100_000 if quick else 1_000_000
    x = jax.random.normal(kx, (n, 128), dtype=jnp.float32)
    pq = Pq(codebooks=jax.random.normal(kc, (16, 256, 8), dtype=jnp.float32))
    method = "kernel" if kernels_run() else "exact"
    enc = jax.jit(lambda p, v: p.quantize_batch(v))
    dt = timeit(enc, pq, x, iters=8)
    record(f"config2_encode_1Mx128_m16_k256_{method}", dt,
           extra={"vectors_per_sec": round(n / dt, 1)})

    if method == "kernel" and not quick:
        # Large-batch serving rate.
        del x
        n8 = 8_000_000
        x8 = jax.random.normal(kx, (n8, 128), dtype=jnp.float32)
        dt = timeit(enc, pq, x8, iters=4)
        record("config2_encode_8Mx128_m16_k256_kernel", dt,
               extra={"vectors_per_sec": round(n8 / dt, 1),
                      "note": "large-batch serving rate"})
        del x8
        x = jax.random.normal(kx, (n, 128), dtype=jnp.float32)

    codes = enc(pq, x)
    dec = jax.jit(primitives.reconstruct_batch)
    dt = timeit(dec, pq.codebooks, codes, iters=8)
    record("config2_decode_1Mx128_gather", dt,
           extra={"vectors_per_sec": round(n / dt, 1)})


def bench_config3(quick):
    """GaussianOpq m=20, k=256 on 300-d embeddings (closed-form rotation).

    (BASELINE.json says m=16 on 300-d, but 300 % 16 != 0 violates the
    reference's own divisibility invariant — src/pq/pq.rs:84-89 — so the
    nearest valid config m=20, ds=15 is used.)
    """
    from reductive_tpu import train_gaussian_opq

    key = jax.random.PRNGKey(4)
    kx, kt = jax.random.split(key)
    n = 4_000 if quick else 50_000
    x = jax.random.normal(kx, (n, 300), dtype=jnp.float32)
    t0 = time.perf_counter()
    pq = train_gaussian_opq(kt, x, 20, 8, 10, 1)
    jax.block_until_ready(pq.codebooks)
    record("config3_train_gaussian_opq_m20_k256_300d", time.perf_counter() - t0,
           extra={"note": "includes jit compile"})


def bench_config4(quick):
    """Opq full alternating optimization, m=24, k=256 on 768-d embeddings."""
    from reductive_tpu import train_opq

    key = jax.random.PRNGKey(5)
    kx, kt = jax.random.split(key)
    n = 4_000 if quick else 20_000
    x = jax.random.normal(kx, (n, 768), dtype=jnp.float32)
    t0 = time.perf_counter()
    pq = train_opq(kt, x, 24, 8, 5 if quick else 10)
    jax.block_until_ready(pq.codebooks)
    record("config4_train_opq_m24_k256_768d", time.perf_counter() - t0,
           extra={"note": "includes jit compile"})


def bench_config5(quick):
    """Streaming encode + ADC search on a 768-d corpus."""
    from reductive_tpu import Pq
    from reductive_tpu.data import stream_encode_batches
    from reductive_tpu.search import search

    key = jax.random.PRNGKey(6)
    kx, kc, kq = jax.random.split(key, 3)
    # The streaming phase includes the host->device copy; config2
    # measures on-device encode throughput.
    n = 20_000 if quick else 65_536
    batch = 16_384
    d, m, k = 768, 24, 256
    cb = jax.random.normal(kc, (m, k, d // m), dtype=jnp.float32)
    pq = Pq(codebooks=cb)

    import numpy as np

    rng = np.random.default_rng(0)
    chunks = [
        (off, rng.standard_normal((min(batch, n - off), d)).astype(np.float32))
        for off in range(0, n, batch)
    ]
    t0 = time.perf_counter()
    codes = np.concatenate(
        [c for _, c in stream_encode_batches(pq, iter(chunks), batch_size=batch)]
    )
    dt = time.perf_counter() - t0
    record("config5_stream_encode_768d", dt,
           extra={"vectors_per_sec": round(n / dt, 1),
                  "note": "includes compile and the host->device copy"})

    queries = jax.random.normal(kq, (16, d), dtype=jnp.float32)
    codes_j = jnp.asarray(codes)
    if not quick:
        # Search over a larger on-device corpus than was streamed.
        from reductive_tpu.data import _encode_fn
        from reductive_tpu.dispatch import use_kernel

        extra_codes = _encode_fn(pq, jnp.uint8, use_kernel("encode"))(
            pq.codebooks, None,
            jax.random.normal(kx, (500_000 - n, d), dtype=jnp.float32),
        )
        codes_j = jnp.concatenate([codes_j, extra_codes])
        n = codes_j.shape[0]
    for nq in (16, 128):
        q = queries if nq == 16 else jax.random.normal(kq, (nq, d), dtype=jnp.float32)
        fn = lambda: search(pq, q, codes_j, top_k=10)[1]
        dt = timeit(lambda: fn(), iters=3)
        record(f"config5_adc_search_{nq}q", dt,
               extra={"corpus": n, "queries_x_vectors_per_sec": round(nq * n / dt, 1)})


def bench_config5_decomposed(quick):
    """BASELINE config #5 (100M x 768-d streaming encode), decomposed.

    The end-to-end pipeline rate is min(disk+convert, host->device link,
    device encode); this group measures each stage separately so the
    bottleneck is explicit; a projected pipeline rate at a stated PCIe
    bandwidth is derived from the measured device and disk rates.
    """
    import os
    import tempfile

    import numpy as np

    d, m, k = 768, 24, 256
    key = jax.random.PRNGKey(9)
    kx, kc = jax.random.split(key)
    cb = jax.random.normal(kc, (m, k, d // m), dtype=jnp.float32)

    # --- Stage 1: device-resident encode rate at d=768 ------------------
    n_dev = 20_000 if quick else 500_000
    x = jax.random.normal(kx, (n_dev, d), dtype=jnp.float32)
    if kernels_run():
        from reductive_tpu.ops import pq_encode

        fn = jax.jit(lambda c, x: pq_encode(c, x, dtype=jnp.uint8))
        dt = timeit(fn, cb, x, iters=3 if quick else 8)
        device_rate = n_dev / dt
        record("config5_device_encode_768d_m24_k256", dt,
               extra={"vectors_per_sec": round(device_rate, 1),
                      "note": "resident data: pure kernel rate at d=768"})
    else:
        device_rate = None

    # --- Stage 2: host->device link bandwidth ---------------------------
    n_h2d = 4_096 if quick else 65_536
    host_buf = np.random.default_rng(0).standard_normal((n_h2d, d)).astype(np.float32)
    jax.device_put(host_buf).block_until_ready()  # warm path
    t0 = time.perf_counter()
    reps = 2 if quick else 4
    for _ in range(reps):
        dev = jax.device_put(host_buf)
        dev.block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    link_gbps = host_buf.nbytes / dt / 1e9
    record("config5_h2d_link_bandwidth", dt,
           extra={"gbytes_per_sec": round(link_gbps, 3),
                  "vectors_per_sec_at_768d": round(link_gbps * 1e9 / (d * 4), 1),
                  "note": "measured host->device"})

    # --- Stage 3: disk + convert rate (native prefetch reader) ----------
    from reductive_tpu.native import VecsReader, write_fvecs

    n_disk = 20_000 if quick else 200_000
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "corpus.fvecs")
        write_fvecs(path, np.random.default_rng(1)
                    .standard_normal((n_disk, d)).astype(np.float32))
        os.system(f"sync")  # page cache holds it anyway; measures read+convert
        with VecsReader(path) as r:
            t0 = time.perf_counter()
            rows = 0
            for off, batch in r.prefetch_batches(16_384, 0, n_disk):
                rows += batch.shape[0]
            dt = time.perf_counter() - t0
        disk_rate = rows / dt
        record("config5_disk_convert_768d", dt,
               extra={"vectors_per_sec": round(disk_rate, 1),
                      "gbytes_per_sec": round(rows * d * 4 / dt / 1e9, 3)})

        # --- Stage 4: measured end-to-end pipeline ----------------------
        from reductive_tpu import Pq
        from reductive_tpu.data import stream_encode

        pq = Pq(codebooks=cb)
        with VecsReader(path) as r:
            _ = stream_encode(pq, r, batch_size=16_384, stop=min(n_disk, 32_768))
            t0 = time.perf_counter()
            codes = stream_encode(pq, r, batch_size=16_384)
            dt = time.perf_counter() - t0
        pipeline_rate = codes.shape[0] / dt
        extra = {"vectors_per_sec": round(pipeline_rate, 1)}

        # Same pipeline with bfloat16 wire transfer (half the link bytes;
        # codes of the bf16-rounded rows).  Warm the bf16-input program
        # first — a different input dtype is a fresh compile.
        with VecsReader(path) as r:
            _ = stream_encode(
                pq, r, batch_size=16_384, stop=min(n_disk, 32_768),
                transfer_dtype=jnp.bfloat16,
            )
            t0 = time.perf_counter()
            codes_bf = stream_encode(
                pq, r, batch_size=16_384, transfer_dtype=jnp.bfloat16
            )
            dt_bf = time.perf_counter() - t0
        record("config5_pipeline_768d_bf16_wire", dt_bf,
               extra={"vectors_per_sec": round(codes_bf.shape[0] / dt_bf, 1),
                      "codes_identical": bool((codes_bf == codes).all())})
        if device_rate:
            # The pipeline is bounded by its slowest stage; state the
            # projection at a PCIe gen4 x16 host link (~16 GB/s usable).
            pcie = 16e9 / (d * 4)
            extra["bottleneck"] = (
                "h2d link" if pipeline_rate < 0.5 * min(disk_rate, device_rate)
                else "disk/convert" if disk_rate < device_rate else "device"
            )
            extra["projected_vectors_per_sec_pcie16GBps"] = round(
                min(device_rate, disk_rate, pcie), 1
            )
        record("config5_pipeline_768d", dt, extra=extra)


def bench_config5_u4(quick):
    """4-bit (k=16, the reference's own bench bit-width) ADC over a
    packed-u4 corpus: half the code bytes of u8, nibbles split in the
    ADC kernel."""
    from reductive_tpu import Pq
    from reductive_tpu.ops import pack_u4_codes
    from reductive_tpu.ops.adc import adc_scores_kernel
    from reductive_tpu.search import adc_tables

    if not kernels_run():
        return  # the ADC kernel runs on a GPU only
    m, k, ds = 16, 16, 8
    n = 100_000 if quick else 2_000_000
    kc, kx, kq = jax.random.split(jax.random.PRNGKey(10), 3)
    pq = Pq(codebooks=jax.random.normal(kc, (m, k, ds), dtype=jnp.float32))
    codes = jax.random.randint(kx, (n, m), 0, k).astype(jnp.uint8)
    packed = pack_u4_codes(codes)
    for nq in (16, 128):
        queries = jax.random.normal(kq, (nq, m * ds), dtype=jnp.float32)
        tables = adc_tables(pq, queries)
        for pk, cd, tag in ((False, codes, "u8"), (True, packed, "u4packed")):
            fn = lambda: adc_scores_kernel(tables, cd, packed=pk)
            dt = timeit(lambda: fn(), iters=3 if quick else 6)
            record(f"config5_adc_4bit_{nq}q_{tag}", dt,
                   extra={"corpus": n,
                          "queries_x_vectors_per_sec": round(nq * n / dt, 1),
                          "code_bytes_per_vector": m // 2 if pk else m})


def bench_config6(quick):
    """Large-corpus Lloyd's iteration (encode kernel + segment_sum
    statistics): 1M x 128, m=16, k=256 — a shape whose (m, n, k) distance
    tensor is 16 GB."""
    from reductive_tpu.pq.train import lloyd_iteration_chunked

    key = jax.random.PRNGKey(7)
    n = 100_000 if quick else 1_000_000
    m, k, ds = 16, 256, 8
    x = jax.random.normal(key, (n, m * ds), dtype=jnp.float32)
    cb = jax.random.normal(jax.random.PRNGKey(8), (m, k, ds), dtype=jnp.float32)
    sumsq = jnp.sum(x.reshape(n, m, ds) ** 2, axis=(0, 2))

    on_gpu = kernels_run()
    fn = lambda: lloyd_iteration_chunked(x, cb, sumsq, use_kernel=on_gpu)
    dt = timeit(lambda: fn(), iters=3 if quick else 8)
    record("config6_lloyd_iteration_1Mx128", dt,
           extra={"vectors_per_sec": round(n / dt, 1)})

    # Full chunked OPQ alternation (stats + streamed Procrustes) at scale.
    import functools

    from reductive_tpu.pq.opq import _opq_iteration_chunked

    R = jnp.eye(m * ds, dtype=jnp.float32)
    step = jax.jit(functools.partial(
        _opq_iteration_chunked, chunk=32768, use_kernel=on_gpu,
    ))
    dt = timeit(lambda: step(x, R, cb), iters=2 if quick else 5)
    record("config6_opq_alternation_1Mx128", dt,
           extra={"vectors_per_sec": round(n / dt, 1)})


def bench_config7_ivf(quick):
    """IVF-PQ vs exhaustive ADC at 1M x 128: wall time and recall@10
    against exact ground truth on clustered (Gaussian-mixture) data."""
    import numpy as np

    from reductive_tpu.ivf import build_ivf, ivf_search, train_ivf_pq
    from reductive_tpu.search import search

    n = 100_000 if quick else 1_000_000
    C = 256 if quick else 1024
    d, m, bits, nq = 128, 16, 8, 16
    kc, kn, kq, kt = jax.random.split(jax.random.PRNGKey(11), 4)
    centers = jax.random.normal(kc, (C, d), dtype=jnp.float32) * 3.0
    member = jax.random.randint(kn, (n,), 0, C)
    x = jnp.take(centers, member, axis=0) + 0.3 * jax.random.normal(
        jax.random.PRNGKey(12), (n, d), dtype=jnp.float32
    )
    queries = x[:: n // nq][:nq] + 0.05 * jax.random.normal(
        kq, (nq, d), dtype=jnp.float32
    )
    # Exact ground truth in chunks (1M x 16 distances).
    best = jnp.full((nq, 10), jnp.inf), jnp.zeros((nq, 10), jnp.int32)
    step = 250_000
    for off in range(0, n, step):
        d2 = jnp.sum((queries[:, None, :] - x[None, off:off + step, :]) ** 2, axis=-1)
        neg, idx = jax.lax.top_k(-d2, 10)
        cat_d = jnp.concatenate([best[0], -neg], axis=1)
        cat_i = jnp.concatenate([best[1], idx + off], axis=1)
        neg2, sel = jax.lax.top_k(-cat_d, 10)
        best = -neg2, jnp.take_along_axis(cat_i, sel, axis=1)
    true10 = np.asarray(best[1])

    t0 = time.perf_counter()
    coarse, pq = train_ivf_pq(
        jax.random.PRNGKey(13), x, C, m, bits,
        coarse_iterations=8, pq_iterations=8,
    )
    index = build_ivf(coarse, pq, x, capacity="auto")
    record("config7_ivf_build_1Mx128", time.perf_counter() - t0,
           extra={"n_cells": C, "capacity": index.capacity,
                  "note": "train (sampled) + full assign/encode/scatter, incl compile"})

    # Exhaustive ADC baseline: a flat (non-residual) PQ on the raw data.
    from reductive_tpu import train_pq_chunked

    flat_pq = train_pq_chunked(kt, x[:262_144], m, bits, 8)
    codes_flat = encode_all(flat_pq, x)
    method = "auto"
    fn_ex = lambda: search(flat_pq, queries, codes_flat, top_k=10, method=method)[1]
    dt_ex = timeit(lambda: fn_ex(), iters=2 if quick else 5)
    i_ex = np.asarray(fn_ex())
    recall_ex = np.mean([
        len(set(i_ex[q]) & set(true10[q])) / 10 for q in range(nq)
    ])
    r1_ex = np.mean([true10[q][0] in i_ex[q] for q in range(nq)])
    record("config7_exhaustive_adc_16q", dt_ex,
           extra={"corpus": n, "recall10": round(float(recall_ex), 3),
                  "one_recall_at_10": round(float(r1_ex), 3)})

    def ivf_row(name, idx_obj, fn, extra=None):
        dt = timeit(lambda: fn(), iters=2 if quick else 5)
        idx = np.asarray(fn())
        recall = np.mean([
            len(set(idx[q]) & set(true10[q])) / 10 for q in range(nq)
        ])
        r1 = np.mean([true10[q][0] in idx[q] for q in range(nq)])
        record(name, dt,
               extra={"corpus": n, "recall10": round(float(recall), 3),
                      "one_recall_at_10": round(float(r1), 3),
                      "speedup_vs_exhaustive": round(dt_ex / dt, 2),
                      **(extra or {})})

    for nprobe in (8, 32):
        ivf_row(
            f"config7_ivf_search_16q_nprobe{nprobe}", index,
            lambda: ivf_search(index, queries, top_k=10, nprobe=nprobe)[1],
            extra={"scanned_fraction": round(nprobe / C, 4)},
        )

    # Recall ladder past the 16-byte PQ resolution ceiling: candidate
    # recall saturates by nprobe=8 (the flat 0.331 plateau), so the
    # levers are (a) exact re-scoring of the shortlist, (b) a rotated
    # (GaussianOpq) residual quantizer, (c) more code bytes (m=32) —
    # the same ladder config8 demonstrates on correlated data.
    ivf_row(
        "config7_ivf_nprobe8_refine4", index,
        lambda: ivf_search(index, queries, top_k=10, nprobe=8,
                           refine_with=x, refine_factor=4)[1],
        extra={"note": "exact re-scoring of 40 candidates per query"},
    )

    coarse_o, pq_o = train_ivf_pq(
        jax.random.PRNGKey(13), x, C, m, bits,
        coarse_iterations=8, pq_iterations=8,
        residual_quantizer="gaussian_opq",
    )
    index_o = build_ivf(coarse_o, pq_o, x, capacity="auto")
    ivf_row(
        "config7_ivf_nprobe8_opq_residual", index_o,
        lambda: ivf_search(index_o, queries, top_k=10, nprobe=8)[1],
        extra={"note": "GaussianOpq rotation on the residual space"},
    )

    coarse32, pq32 = train_ivf_pq(
        jax.random.PRNGKey(13), x, C, 2 * m, bits,
        coarse_iterations=8, pq_iterations=8,
    )
    index32 = build_ivf(coarse32, pq32, x, capacity="auto")
    ivf_row(
        "config7_ivf_nprobe8_m32", index32,
        lambda: ivf_search(index32, queries, top_k=10, nprobe=8)[1],
        extra={"note": "32-byte codes (m=32): 2x code resolution"},
    )


def _exact_top10(queries, x, n):
    """Chunked exact brute-force ground truth (never materializes (nq, n))."""
    import numpy as np

    nq = queries.shape[0]
    best = jnp.full((nq, 10), jnp.inf), jnp.zeros((nq, 10), jnp.int32)
    step = 250_000
    for off in range(0, n, step):
        d2 = jnp.sum(
            (queries[:, None, :] - x[None, off:off + step, :]) ** 2, axis=-1
        )
        neg, idx = jax.lax.top_k(-d2, 10)
        cat_d = jnp.concatenate([best[0], -neg], axis=1)
        cat_i = jnp.concatenate([best[1], idx + off], axis=1)
        neg2, sel = jax.lax.top_k(-cat_d, 10)
        best = -neg2, jnp.take_along_axis(cat_i, sel, axis=1)
    return np.asarray(best[1])


def bench_config8_recall(quick):
    """Recall-vs-latency methodology table on two data distributions at
    matched bytes (m=16, k=256 -> 16 bytes/vector everywhere):

    * ``isotropic`` — unit Gaussian, clusterless: the WORST case for IVF
      (coarse cells carve noise) and the EASIEST for PQ (independent
      subvectors), i.e. the distribution round-2 recall numbers used.
    * ``correlated`` — SIFT-like: a 512-center Gaussian mixture living in
      a low-rank (rank-24) subspace with anisotropic within-cluster
      noise — realistic embedding structure where coarse quantization
      earns its keep and raw PQ suffers from correlated subvectors.

    For each distribution: exhaustive ADC, exhaustive + exact refine,
    IVF at nprobe in {4, 16, 64}, and IVF + exact refine, each with
    recall@10 against chunked exact brute force and wall latency for a
    16-query batch.  (VERDICT round 2, weak #8.)
    """
    import numpy as np

    from reductive_tpu import train_pq_chunked
    from reductive_tpu.ivf import build_ivf, ivf_search, train_ivf_pq
    from reductive_tpu.search import search

    n = 50_000 if quick else 1_000_000
    C = 128 if quick else 1024
    d, m, bits, nq = 128, 16, 8, 16
    method = "auto"

    def gen_isotropic(key):
        return jax.random.normal(key, (n, d), dtype=jnp.float32)

    def gen_correlated(key):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        r = 24
        A = jax.random.normal(k1, (r, d), dtype=jnp.float32)
        centers = jnp.dot(
            jax.random.normal(k2, (512, r), dtype=jnp.float32) * 2.0, A
        ) / jnp.sqrt(r)
        member = jax.random.randint(k3, (n,), 0, 512)
        # Anisotropic within-cluster noise: mostly in the same low-rank
        # subspace plus a small isotropic floor.
        noise = jnp.dot(
            jax.random.normal(k4, (n, r), dtype=jnp.float32) * 0.4, A
        ) / jnp.sqrt(r)
        iso = 0.05 * jax.random.normal(k5, (n, d), dtype=jnp.float32)
        return jnp.take(centers, member, axis=0) + noise + iso

    for dist, gen in (("isotropic", gen_isotropic),
                      ("correlated", gen_correlated)):
        x = gen(jax.random.PRNGKey(21))
        queries = x[:: n // nq][:nq] + 0.02 * jax.random.normal(
            jax.random.PRNGKey(22), (nq, d), dtype=jnp.float32
        )
        true10 = _exact_top10(queries, x, n)

        def recall(ids):
            return float(np.mean([
                len(set(np.asarray(ids)[q]) & set(true10[q])) / 10
                for q in range(nq)
            ]))

        flat_pq = train_pq_chunked(
            jax.random.PRNGKey(23), x[:262_144], m, bits, 8,
        )
        codes = encode_all(flat_pq, x)
        coarse, rpq = train_ivf_pq(
            jax.random.PRNGKey(24), x, C, m, bits,
            coarse_iterations=8, pq_iterations=8,
        )
        index = build_ivf(coarse, rpq, x, capacity="auto")

        fn = lambda: search(flat_pq, queries, codes, top_k=10, method=method)[1]
        dt = timeit(lambda: fn(), iters=2 if quick else 5)
        record(f"config8_{dist}_exhaustive_adc", dt,
               extra={"recall10": round(recall(fn()), 3), "bytes_per_vec": m})

        fn = lambda: search(flat_pq, queries, codes, top_k=10, method=method,
                            refine_with=x, refine_factor=4)[1]
        dt = timeit(lambda: fn(), iters=2 if quick else 5)
        record(f"config8_{dist}_exhaustive_adc_refine4", dt,
               extra={"recall10": round(recall(fn()), 3), "bytes_per_vec": m})

        for nprobe in (4, 16, 64):
            fn = lambda: ivf_search(index, queries, top_k=10, nprobe=nprobe)[1]
            dt = timeit(lambda: fn(), iters=2 if quick else 5)
            record(f"config8_{dist}_ivf_nprobe{nprobe}", dt,
                   extra={"recall10": round(recall(fn()), 3),
                          "scanned_fraction": round(nprobe / C, 4),
                          "bytes_per_vec": m})

        fn = lambda: ivf_search(index, queries, top_k=10, nprobe=16, refine_with=x,
                                refine_factor=4)[1]
        dt = timeit(lambda: fn(), iters=2 if quick else 5)
        record(f"config8_{dist}_ivf_nprobe16_refine4", dt,
               extra={"recall10": round(recall(fn()), 3), "bytes_per_vec": m})


def _exact_top10_ip(queries, x, n):
    """Chunked exact MIPS ground truth (never materializes (nq, n))."""
    import numpy as np

    nq = queries.shape[0]
    best = jnp.full((nq, 10), -jnp.inf), jnp.zeros((nq, 10), jnp.int32)
    step = 250_000
    for off in range(0, n, step):
        ip = jnp.dot(queries, x[off:off + step].T,
                     preferred_element_type=jnp.float32)
        val, idx = jax.lax.top_k(ip, 10)
        cat_v = jnp.concatenate([best[0], val], axis=1)
        cat_i = jnp.concatenate([best[1], idx + off], axis=1)
        val2, sel = jax.lax.top_k(cat_v, 10)
        best = val2, jnp.take_along_axis(cat_i, sel, axis=1)
    return np.asarray(best[1])


def bench_config9_mips(quick):
    """MIPS/cosine serving (metric="dot"): recall@10 vs exact inner
    product on an L2-normalized correlated corpus (the cosine regime,
    where embedding serving actually lives).  Exhaustive dot-ADC, + exact
    refine, IVF-IP at nprobe in {4, 16}, and IVF-IP + refine, all at
    matched 16 bytes/vector; latency for a 16-query batch."""
    import numpy as np

    from reductive_tpu import train_pq_chunked
    from reductive_tpu.ivf import build_ivf, ivf_search, train_ivf_pq
    from reductive_tpu.search import search

    n = 50_000 if quick else 1_000_000
    C = 128 if quick else 1024
    d, m, bits, nq = 128, 16, 8, 16
    method = "auto"

    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(31), 5)
    r = 24
    A = jax.random.normal(k1, (r, d), dtype=jnp.float32)
    centers = jnp.dot(
        jax.random.normal(k2, (512, r), dtype=jnp.float32) * 2.0, A
    ) / jnp.sqrt(r)
    member = jax.random.randint(k3, (n,), 0, 512)
    noise = jnp.dot(
        jax.random.normal(k4, (n, r), dtype=jnp.float32) * 0.4, A
    ) / jnp.sqrt(r)
    x = jnp.take(centers, member, axis=0) + noise + 0.05 * jax.random.normal(
        k5, (n, d), dtype=jnp.float32
    )
    x = x / jnp.linalg.norm(x, axis=1, keepdims=True)
    queries = x[:: n // nq][:nq] + 0.02 * jax.random.normal(
        jax.random.PRNGKey(32), (nq, d), dtype=jnp.float32
    )
    queries = queries / jnp.linalg.norm(queries, axis=1, keepdims=True)
    true10 = _exact_top10_ip(queries, x, n)

    def recall(ids):
        return float(np.mean([
            len(set(np.asarray(ids)[q]) & set(true10[q])) / 10
            for q in range(nq)
        ]))

    flat_pq = train_pq_chunked(
        jax.random.PRNGKey(33), x[:262_144], m, bits, 8,
    )
    codes = encode_all(flat_pq, x)
    coarse, rpq = train_ivf_pq(
        jax.random.PRNGKey(34), x, C, m, bits,
        coarse_iterations=8, pq_iterations=8,
    )
    index = build_ivf(coarse, rpq, x, capacity="auto")

    fn = lambda: search(flat_pq, queries, codes, top_k=10, method=method,
                        metric="dot")[1]
    dt = timeit(lambda: fn(), iters=2 if quick else 5)
    record("config9_mips_exhaustive_dot_adc", dt,
           extra={"recall10": round(recall(fn()), 3), "bytes_per_vec": m})

    fn = lambda: search(flat_pq, queries, codes, top_k=10, method=method,
                        metric="dot", refine_with=x, refine_factor=4)[1]
    dt = timeit(lambda: fn(), iters=2 if quick else 5)
    record("config9_mips_exhaustive_dot_refine4", dt,
           extra={"recall10": round(recall(fn()), 3), "bytes_per_vec": m})

    def candidate_recall(idx_obj, nprobe):
        """Fraction of true top-10 ids whose cell is among the probed
        cells — isolates the coarse quantizer's contribution from the PQ
        resolution bottleneck (probing follows ivf.py's metric="dot"
        rule: top-nprobe by query-centroid inner product)."""
        qc = jnp.dot(queries, idx_obj.coarse_centroids.T,
                     precision="highest")
        _, probe = jax.lax.top_k(qc, nprobe)
        ids_g = np.asarray(
            jnp.take(idx_obj.cell_ids, probe, axis=0)
        ).reshape(nq, -1)
        return float(np.mean([
            len(set(ids_g[q]) & set(true10[q])) / 10 for q in range(nq)
        ]))

    for nprobe in (4, 16):
        fn = lambda: ivf_search(index, queries, top_k=10, nprobe=nprobe, metric="dot")[1]
        dt = timeit(lambda: fn(), iters=2 if quick else 5)
        record(f"config9_mips_ivf_nprobe{nprobe}", dt,
               extra={"recall10": round(recall(fn()), 3),
                      "candidate_recall10":
                          round(candidate_recall(index, nprobe), 3),
                      "scanned_fraction": round(nprobe / C, 4),
                      "bytes_per_vec": m})

    fn = lambda: ivf_search(index, queries, top_k=10, nprobe=16, metric="dot",
                            refine_with=x, refine_factor=4)[1]
    dt = timeit(lambda: fn(), iters=2 if quick else 5)
    record("config9_mips_ivf_nprobe16_refine4", dt,
           extra={"recall10": round(recall(fn()), 3), "bytes_per_vec": m})

    # Spherical-vs-L2 coarse A/B: same corpus, same PQ budget, coarse
    # k-means trained with coarse_metric="spherical" (unit-norm centroids,
    # dot-product assignment — ivf.py) instead of the default L2.  The
    # rows pair with the L2 ones above so the recall delta that motivated
    # the spherical option is an actual measurement, not a claim.
    coarse_s, rpq_s = train_ivf_pq(
        jax.random.PRNGKey(34), x, C, m, bits,
        coarse_iterations=8, pq_iterations=8, coarse_metric="spherical",
    )
    index_s = build_ivf(coarse_s, rpq_s, x, capacity="auto")
    for nprobe in (4, 16):
        fn = lambda: ivf_search(index_s, queries, top_k=10, nprobe=nprobe, metric="dot")[1]
        dt = timeit(lambda: fn(), iters=2 if quick else 5)
        record(f"config9_mips_ivf_spherical_nprobe{nprobe}", dt,
               extra={"recall10": round(recall(fn()), 3),
                      "candidate_recall10":
                          round(candidate_recall(index_s, nprobe), 3),
                      "scanned_fraction": round(nprobe / C, 4),
                      "bytes_per_vec": m, "coarse_metric": "spherical"})

    fn = lambda: ivf_search(index_s, queries, top_k=10, nprobe=16, metric="dot",
                            refine_with=x, refine_factor=4)[1]
    dt = timeit(lambda: fn(), iters=2 if quick else 5)
    record("config9_mips_ivf_spherical_nprobe16_refine4", dt,
           extra={"recall10": round(recall(fn()), 3), "bytes_per_vec": m,
                  "coarse_metric": "spherical"})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small shapes (CPU/CI)")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated bench group names")
    args = ap.parse_args()

    from reductive_tpu.utils import enable_compile_cache

    enable_compile_cache()

    groups = {
        "linalg": bench_linalg,
        "refshapes": bench_reference_pq_shapes,
        "config1": bench_config1,
        "config2": bench_config2,
        "config3": bench_config3,
        "config4": bench_config4,
        "config5": bench_config5,
        "config5x": bench_config5_decomposed,
        "config5u4": bench_config5_u4,
        "config6": bench_config6,
        "config7": bench_config7_ivf,
        "config8": bench_config8_recall,
        "config9": bench_config9_mips,
    }
    selected = args.only.split(",") if args.only else list(groups)
    for name in selected:
        groups[name](args.quick)

    if args.out:
        Path(args.out).write_text(json.dumps(RESULTS, indent=1))


if __name__ == "__main__":
    main()

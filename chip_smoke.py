"""Smoke run of reductive-tpu on one NVIDIA GPU, through the public API.

Drives the main path once at the widths users run, on random data made
from ``--seed``:

1. device: platform, kind and count, and the card's name and power limit;
2. PQ at the SIFT1M shape (1,000,000 x 128, m=16, k=256): chunked
   training (run twice, and checkpointed and resumed, for bit-equal
   codebooks), encode of all rows and of the 8M-row headline batch,
   reconstruction, the Lloyd's statistics;
3. OPQ at the 768-d embedding shape (1,000,000 x 768, m=24, k=256);
4. exhaustive ADC search (100 queries, top-10, l2 and dot) and packed-u4
   search (m=16, k=16);
5. IVF-PQ: ``train_ivf_pq`` (C=1024), ``build_ivf`` with ``capacity=None``
   (built on device) and ``capacity="auto"``,
   ``ivf_search`` at nprobe 8 and 32 with and without ``refine_with``,
   ``ivf_add`` of 10k rows.

Every phase compares its result with the host numpy reference
(``tests/reference_numpy.py``) on a fixed sample of 65,536 rows and all
queries, and at full size with the library's plain f32 path; each line
gives the agreement next to its tolerance and the precision used.  The
GPU kernels (encode, ADC) are timed against the plain XLA version they
replace.  Any failed phase makes the script exit non-zero.

``--four`` runs only the four-card phase: a 1-D data mesh over four cards
for ``train_pq_chunked_sharded``, ``encode_sharded``, ``search_sharded``
and ``ivf_search_sharded``, each compared with its single-card form.

``--rehearse`` runs every phase at toy sizes on the CPU with the kernels
in the Pallas interpreter; it checks control flow only and never prints a
result line.

Usage::

    python chip_smoke.py            # one GPU
    python chip_smoke.py --four     # four GPUs
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
sys.path.insert(0, os.path.join(_HERE, "tests"))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


@dataclasses.dataclass(frozen=True)
class Sizes:
    n: int = 1_000_000          # SIFT1M / embedding corpus rows
    headline: int = 8_000_000   # the headline encode batch
    d_sift: int = 128
    m_sift: int = 16
    d_emb: int = 768
    m_emb: int = 24
    bits: int = 8
    sample: int = 65_536        # rows checked against the numpy reference
    nq: int = 100
    cells: int = 1024
    add: int = 10_000
    pq_iters: int = 5
    opq_iters: int = 3
    chunk: int = 32768


REHEARSAL = Sizes(n=6000, headline=8000, d_sift=32, m_sift=4, d_emb=48,
                  m_emb=6, bits=4, sample=2048, nq=7, cells=40, add=300,
                  pq_iters=3, opq_iters=1, chunk=1024)


class Smoke:
    """Shared state of one run: sizes, the card's name for timing lines,
    and the data later phases reuse."""

    def __init__(self, sizes: Sizes, seed: int, card: str):
        self.s = sizes
        self.key = jax.random.PRNGKey(seed)
        self.card = card
        self.failures: list[str] = []
        self.sample_idx = np.sort(np.random.default_rng(seed).choice(
            sizes.n, size=min(sizes.sample, sizes.n), replace=False))

    def fold(self, tag: int):
        return jax.random.fold_in(self.key, tag)

    def timed(self, label: str, fn, *args, reps: int = 3, rows=None):
        """Compile and warm ``fn(*args)``, then print the median of
        ``reps`` warm calls ended by ``block_until_ready``.  ``reps=0``
        times the one (cold) call, compilation included."""
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        first = time.perf_counter() - t0
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        t = float(np.median(ts)) if ts else first
        rate = f", {rows / t / 1e6:.1f}M rows/s" if rows else ""
        how = (f"warm median of {reps}; first call incl. compile {first:.1f} s"
               if reps else "one cold call incl. compile")
        print(f"  time [{self.card}] {label}: {t * 1e3:.3f} ms{rate} ({how})",
              flush=True)
        return out, t

    def check(self, label: str, value: float, limit: float, *, at_least: bool,
              precision: str):
        ok = value >= limit if at_least else value <= limit
        op = ">=" if at_least else "<="
        print(f"  check {label}: {value:.7g} (tolerance {op} {limit:g}; "
              f"{precision}) {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"{label}: {value} not {op} {limit}")


def clustered(key, n: int, d: int, centers_key=None, centers: int = 256) -> jax.Array:
    """``(n, d)`` f32 rows from a mixture of Gaussians, made on device.
    ``centers_key`` fixes the mixture, so queries and added rows can be
    drawn from the corpus's distribution."""
    kc, ka, kn = jax.random.split(key, 3)
    if centers_key is not None:
        kc = centers_key
    mu = 3.0 * jax.random.normal(kc, (centers, d), jnp.float32)
    which = jax.random.randint(ka, (n,), 0, centers)
    return mu[which] + jax.random.normal(kn, (n, d), jnp.float32)


def memory_line(label: str, fn, *args):
    mem = jax.jit(fn).lower(*args).compile().memory_analysis()
    print(f"  memory {label}: {mem}", flush=True)


def plain_encode(codebooks, x, chunk: int):
    """The plain XLA encode (``primitives.quantize_batch``, f32
    ``precision="highest"``) run chunk by chunk under ``lax.map``: the
    full ``(n, m, k)`` distance tensor would not fit at the headline size."""
    from reductive_tpu.pq import primitives

    n, d = x.shape
    main = (n // chunk) * chunk
    out = jax.lax.map(
        lambda xc: primitives.quantize_batch(codebooks, xc),
        x[:main].reshape(-1, chunk, d),
    ).reshape(main, -1)
    if main < n:
        out = jnp.concatenate(
            [out, primitives.quantize_batch(codebooks, x[main:])])
    return out


def agreement(a, b) -> float:
    return float(np.mean(np.asarray(a) == np.asarray(b)))


def tie_report(label: str, ids, dists, ids_ref, dists_ref) -> None:
    """Print how many ids equal the reference's position by position and,
    where they differ, how far apart the two paths' distances are."""
    ids, ids_ref = np.asarray(ids), np.asarray(ids_ref)
    dists, dists_ref = np.asarray(dists), np.asarray(dists_ref)
    differ = ids != ids_ref
    gap = (float(np.max(np.abs(dists - dists_ref)[differ]
                        / np.maximum(np.abs(dists_ref[differ]), 1)))
           if differ.any() else 0.0)
    print(f"  {label}: ids equal position by position {1 - differ.mean():.4f}; "
          f"where they differ, max relative distance gap {gap:.3g}", flush=True)


def bit_agreement(a, b) -> float:
    """Share of f32 entries whose bits are equal."""
    return agreement(np.asarray(a, np.float32).view(np.uint32),
                     np.asarray(b, np.float32).view(np.uint32))


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def phase_pq(sm: Smoke):
    """PQ at the SIFT1M shape: chunked training, encode, reconstruct."""
    import reference_numpy as ref
    from reductive_tpu import train_pq_chunked
    from reductive_tpu.ops import assign
    from reductive_tpu.pq import primitives
    from reductive_tpu.pq.train import lloyd_iteration_chunked, sorted_segment_sum

    s = sm.s
    m, k = s.m_sift, 2 ** s.bits
    x = clustered(sm.fold(1), s.n, s.d_sift, centers_key=sm.fold(100))
    sm.x_sift = x
    xs = np.asarray(x[sm.sample_idx])

    # Training through the public entry point (the encode kernel assigns,
    # segment_sum accumulates), and once on the plain path from the same
    # key for the loss comparison.
    train = functools.partial(train_pq_chunked, sm.fold(2), x, m, s.bits,
                              chunk=s.chunk)
    pq, _ = sm.timed(f"train_pq_chunked {s.n}x{s.d_sift} m={m} k={k} "
                     f"{s.pq_iters} iters", lambda: train(s.pq_iters), reps=0)
    pq_plain = train(s.pq_iters, use_kernel=False)
    sm.pq_sift = pq
    cb = np.asarray(pq.codebooks)

    # Determinism per key: a second run, and a run checkpointed after two
    # iterations and resumed from the artifact, give the same bits.
    from reductive_tpu import io

    sm.check("train_pq_chunked twice from one key: bit-equal codebook share",
             bit_agreement(train(s.pq_iters).codebooks, cb), 1.0, at_least=True,
             precision="f32, sorted segment sums")
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "pq.npz")
        train(2, checkpoint_every=2, checkpoint_path=path)
        resumed = train(s.pq_iters - 2, initial_model=io.load(path))
    sm.check(f"checkpoint after 2 + resume {s.pq_iters - 2} iterations vs straight: "
             "bit-equal codebook share", bit_agreement(resumed.codebooks, cb), 1.0,
             at_least=True, precision="f32, sorted segment sums")

    def mse(model):
        rec = ref.reconstruct_batch(np.asarray(model.codebooks),
                                    ref.quantize_batch(np.asarray(model.codebooks), xs))
        return float(np.mean((xs - rec) ** 2))

    mk, mp = mse(pq), mse(pq_plain)
    sm.check("train_pq_chunked sample MSE vs plain-path training, relative",
             abs(mk - mp) / mp, 1e-3, at_least=False,
             precision="kernel TF32x3 assignment vs einsum f32 highest")

    # One Lloyd's step on the sample against the numpy reference.
    cb0 = jnp.asarray(cb)
    sumsq = jnp.sum(jnp.asarray(xs).reshape(-1, m, s.d_sift // m) ** 2, axis=(0, 2))
    new_cb, _ = lloyd_iteration_chunked(jnp.asarray(xs), cb0, sumsq,
                                        chunk=s.chunk, use_kernel=True)
    ds = s.d_sift // m
    ref_cb = cb.copy()
    for j in range(m):
        sub = xs[:, j * ds:(j + 1) * ds]
        ref.update_centroids(ref_cb[j], sub, ref.cluster_assignments(ref_cb[j], sub))
    close = float(np.mean(np.isclose(np.asarray(new_cb), ref_cb, rtol=1e-4, atol=1e-4)))
    sm.check("Lloyd's step on sample: codebook entries within 1e-4 of numpy",
             close, 0.999, at_least=True, precision="f32 sorted segment sum vs numpy f32")

    # Encode: sample vs numpy, full size vs the plain einsum, A/B times.
    codes, t_kernel = sm.timed(f"encode kernel {s.n}x{s.d_sift}",
                               jax.jit(assign.pq_encode), pq.codebooks, x,
                               rows=s.n)
    sm.codes_sift = codes
    memory_line("pq_encode kernel", assign.pq_encode, pq.codebooks, x)
    want = ref.quantize_batch(cb, xs)
    sm.check("encode sample agreement with numpy reference",
             agreement(np.asarray(codes)[sm.sample_idx], want), 0.999,
             at_least=True, precision="TF32x3 dots vs numpy f32")
    plain, t_plain = sm.timed(f"encode plain XLA {s.n}x{s.d_sift}",
                              jax.jit(functools.partial(plain_encode, chunk=s.chunk)),
                              pq.codebooks, x, rows=s.n)
    sm.check("encode full-size agreement with einsum precision=highest",
             agreement(codes, plain), 0.9999, at_least=True,
             precision="TF32x3 dots vs f32 highest")
    print(f"  A/B encode {s.n} rows: kernel {t_kernel * 1e3:.3f} ms vs plain "
          f"{t_plain * 1e3:.3f} ms ({t_plain / t_kernel:.2f}x)", flush=True)

    xh = jnp.concatenate([x] * -(-s.headline // s.n))[:s.headline]
    _, t_kh = sm.timed(f"encode kernel headline {s.headline}x{s.d_sift}",
                       jax.jit(assign.pq_encode), pq.codebooks, xh,
                       rows=s.headline)
    _, t_ph = sm.timed(f"encode plain XLA headline {s.headline}x{s.d_sift}",
                       jax.jit(functools.partial(plain_encode, chunk=s.chunk)),
                       pq.codebooks, xh, reps=1, rows=s.headline)
    print(f"  A/B encode {s.headline} rows: kernel {t_kh * 1e3:.3f} ms vs plain "
          f"{t_ph * 1e3:.3f} ms ({t_ph / t_kh:.2f}x)", flush=True)
    del xh

    # Reconstruct: the gather (the only path) vs the one-hot einsum it
    # replaced; bit-exact against numpy.
    rec, _ = sm.timed(f"reconstruct gather {s.n}x{s.d_sift}",
                      jax.jit(primitives.reconstruct_batch), pq.codebooks,
                      codes, rows=s.n)

    def onehot_rec(cbk, c):
        oh = jax.nn.one_hot(c.astype(jnp.int32), k, dtype=cbk.dtype)
        return jnp.einsum("nmk,mkd->nmd", oh, cbk, precision="highest").reshape(
            c.shape[0], -1)

    sm.timed(f"reconstruct one-hot einsum (removed path) {s.n}x{s.d_sift}",
             jax.jit(onehot_rec), pq.codebooks, codes, rows=s.n)
    cs = np.asarray(codes)[sm.sample_idx]
    mism = float(np.mean(np.asarray(rec)[sm.sample_idx] != ref.reconstruct_batch(cb, cs)))
    sm.check("reconstruct sample mismatches vs numpy gather", mism, 0.0,
             at_least=False, precision="bit-exact f32")

    # Statistics on one chunk of codes: the sorted segment sum (the path)
    # vs the one-hot matmul it replaced and the float scatter-add
    # (jax.ops.segment_sum) it avoids, with the number of distinct
    # results over repeated runs.
    xc, cc = x[:s.chunk], codes[:s.chunk].astype(jnp.int32)
    seg = (cc + jnp.arange(m, dtype=jnp.int32)[None, :] * k).reshape(-1)

    def onehot_stats(xc, cc):
        oh = jax.nn.one_hot(cc.T, k, dtype=jnp.float32)
        xm = jnp.moveaxis(xc.reshape(-1, m, ds), 1, 0)
        return jnp.einsum("mck,mcs->mks", oh, xm, precision="highest").reshape(m * k, ds)

    stats = {
        "sorted segment sum (the path)":
            jax.jit(lambda v, g: sorted_segment_sum(v, g, m * k)[0]),
        "scatter-add segment_sum (not used)":
            jax.jit(lambda v, g: jax.ops.segment_sum(v, g, num_segments=m * k)),
    }
    b, _ = sm.timed(f"stats one-hot einsum (removed path), {s.chunk}-row chunk",
                    jax.jit(onehot_stats), xc, cc)
    distinct = {}
    for name, fn in stats.items():
        a, _ = sm.timed(f"stats {name}, {s.chunk}-row chunk", fn, xc.reshape(-1, ds), seg)
        distinct[name] = len({np.asarray(fn(xc.reshape(-1, ds), seg)).tobytes()
                              for _ in range(10)})
        print(f"  stats {name}: {distinct[name]} distinct results in 10 runs", flush=True)
        sm.check(f"stats {name} vs one-hot, max relative",
                 float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b))), 1e-5,
                 at_least=False, precision="f32 sums, different order")
    sm.check("sorted segment sum: distinct results in 10 runs",
             distinct["sorted segment sum (the path)"], 1, at_least=False,
             precision="bit-exact")


def phase_opq(sm: Smoke):
    """OPQ at the 768-d embedding shape: chunked training, encode."""
    import reference_numpy as ref
    from reductive_tpu import train_opq_chunked
    from reductive_tpu.ops import assign

    s = sm.s
    x = clustered(sm.fold(3), s.n, s.d_emb)
    pq, _ = sm.timed(f"train_opq_chunked {s.n}x{s.d_emb} m={s.m_emb} "
                     f"{s.opq_iters} alternations",
                     lambda: train_opq_chunked(sm.fold(4), x, s.m_emb, s.bits,
                                               s.opq_iters, chunk=s.chunk),
                     reps=0)
    R = np.asarray(pq.projection)
    sm.check("OPQ projection orthonormality, max |R^T R - I|",
             float(np.max(np.abs(R.T @ R - np.eye(s.d_emb)))), 1e-3,
             at_least=False, precision="f32")
    codes, t_k = sm.timed(f"Pq.quantize_batch (kernel) {s.n}x{s.d_emb}",
                          jax.jit(lambda p, v: p.quantize_batch(v)),
                          pq, x, rows=s.n)
    rx = jnp.dot(x, pq.projection, precision="highest")
    memory_line("pq_encode kernel 768-d", assign.pq_encode, pq.codebooks, rx)
    xs = np.asarray(x[sm.sample_idx])
    want = ref.quantize_batch(np.asarray(pq.codebooks), xs @ R)
    sm.check("OPQ encode sample agreement with numpy reference",
             agreement(np.asarray(codes)[sm.sample_idx], want), 0.999,
             at_least=True, precision="TF32x3 dots vs numpy f32")
    plain, t_p = sm.timed(f"encode plain XLA {s.n}x{s.d_emb}",
                          jax.jit(functools.partial(plain_encode, chunk=s.chunk)),
                          pq.codebooks, rx, rows=s.n)
    sm.check("OPQ encode full-size agreement with einsum precision=highest",
             agreement(codes, plain), 0.9999, at_least=True,
             precision="TF32x3 dots vs f32 highest")
    print(f"  A/B encode {s.n}x{s.d_emb}: kernel {t_k * 1e3:.3f} ms (incl. rotation) "
          f"vs plain {t_p * 1e3:.3f} ms (rotation excluded)", flush=True)


def phase_search(sm: Smoke):
    """Exhaustive ADC search, both metrics, and packed-u4 search."""
    import reference_numpy as ref
    from reductive_tpu import train_pq_chunked
    from reductive_tpu.ops import adc, pack_u4_codes
    from reductive_tpu.search import adc_scores, adc_tables, search

    s = sm.s
    pq, codes, x = sm.pq_sift, sm.codes_sift, sm.x_sift
    q = clustered(sm.fold(5), s.nq, s.d_sift, centers_key=sm.fold(100))
    cb, qn = np.asarray(pq.codebooks), np.asarray(q)
    sample_codes = codes[jnp.asarray(sm.sample_idx)]
    for metric in ("l2", "dot"):
        dk, ik = search(pq, q, sample_codes, 10, metric=metric)
        scores = ref.adc_distances(cb, qn, np.asarray(sample_codes), metric)
        kth = np.sort(scores, axis=1)[:, 9]
        got = np.take_along_axis(scores, np.asarray(ik), axis=1)
        sm.check(f"search {metric} sample: returned ids within the numpy top-10 "
                 "(by distance, ties allowed)",
                 float(np.mean(got <= kth[:, None] + 1e-4 * np.abs(kth[:, None]))),
                 1.0, at_least=True, precision="f32 table sums vs numpy f64")
        sm.check(f"search {metric} sample: max relative distance error",
                 float(np.max(np.abs(np.asarray(dk) - got) / np.maximum(np.abs(got), 1))),
                 1e-5, at_least=False, precision="f32 table sums vs numpy f64")
        (dk, ik), t_k = sm.timed(f"search kernel {metric} nq={s.nq} top-10 over {s.n}",
                                 lambda: search(pq, q, codes, 10, metric=metric))
        (de, ie), t_e = sm.timed(f"search einsum {metric} nq={s.nq} top-10 over {s.n}",
                                 lambda: search(pq, q, codes, 10, metric=metric,
                                                method="einsum"), reps=1)
        sm.check(f"search {metric} full-size ids equal to einsum path",
                 agreement(ik, ie), 0.999, at_least=True,
                 precision="f32 table sums, different order")
        print(f"  A/B search {metric}: kernel {t_k * 1e3:.3f} ms vs einsum "
              f"{t_e * 1e3:.3f} ms ({t_e / t_k:.2f}x)", flush=True)

    # The scorers alone on one 1M-code block, plus the plain gather-sum.
    tables = adc_tables(pq, q)
    block = codes[: min(s.n, 1 << 20)]
    sk, t_k = sm.timed(f"ADC kernel scores nq={s.nq} x {block.shape[0]}",
                       jax.jit(adc.adc_scores_kernel), tables, block)
    memory_line("adc_scores kernel", adc.adc_scores_kernel, tables, block)
    se, t_e = sm.timed(f"ADC einsum scores nq={s.nq} x {block.shape[0]}",
                       jax.jit(adc_scores), tables, block)

    def gather_sum(t, c, chunk=s.chunk):
        m = c.shape[1]

        def body(_, cc):
            return None, jnp.sum(t[:, jnp.arange(m)[None, :], cc.astype(jnp.int32)], -1)

        main = (c.shape[0] // chunk) * chunk
        _, out = jax.lax.scan(body, None, c[:main].reshape(-1, chunk, m))
        return jnp.moveaxis(out, 0, 1).reshape(t.shape[0], -1)

    _, t_g = sm.timed(f"ADC plain gather-sum scores nq={s.nq} x {block.shape[0]}",
                      jax.jit(gather_sum), tables, block)
    sm.check("ADC kernel vs einsum scores, max relative",
             float(jnp.max(jnp.abs(sk - se)) / jnp.max(jnp.abs(se))), 1e-5,
             at_least=False, precision="f32 sums, different order")
    print(f"  A/B ADC scores: kernel {t_k * 1e3:.3f} ms vs einsum {t_e * 1e3:.3f} ms "
          f"vs gather-sum {t_g * 1e3:.3f} ms", flush=True)

    # Packed u4: m=16, k=16.
    pq4 = train_pq_chunked(sm.fold(6), x, s.m_sift, 4, 3, chunk=s.chunk)
    c4 = pq4.quantize_batch(x)
    packed = pack_u4_codes(c4)
    (dp, ip), t_p = sm.timed(f"search packed-u4 m={s.m_sift} k=16 nq={s.nq} over {s.n}",
                             lambda: search(pq4, q, packed, 10, packed=True))
    de, ie = search(pq4, q, c4, 10, method="einsum")
    sm.check("packed-u4 search ids equal to unpacked einsum path",
             agreement(ip, ie), 0.999, at_least=True,
             precision="f32 table sums, different order")
    scores = ref.adc_distances(np.asarray(pq4.codebooks), qn,
                               np.asarray(c4)[sm.sample_idx], "l2")
    ks, _ = search(pq4, q, packed[jnp.asarray(sm.sample_idx)], 10, packed=True)
    want = np.sort(scores, axis=1)[:, :10]
    sm.check("packed-u4 sample top-10 distances vs numpy, max relative",
             float(np.max(np.abs(np.asarray(ks) - want) / np.maximum(np.abs(want), 1))),
             1e-5, at_least=False, precision="f32 table sums vs numpy f64")
    tp = adc_tables(pq4, q)
    block4 = packed[: min(s.n, 1 << 20)]
    _, t_pk = sm.timed(f"ADC kernel packed-u4 scores nq={s.nq} x {block4.shape[0]}",
                       jax.jit(functools.partial(adc.adc_scores_kernel, packed=True)),
                       tp, block4)
    _, t_pe = sm.timed(f"ADC einsum scores (unpacked) nq={s.nq} x {block4.shape[0]}",
                       jax.jit(adc_scores), tp, c4[: block4.shape[0]])
    print(f"  A/B ADC packed-u4: kernel {t_pk * 1e3:.3f} ms vs einsum "
          f"{t_pe * 1e3:.3f} ms", flush=True)


def phase_ivf(sm: Smoke):
    """IVF-PQ: train, build, search (nprobe 8/32, +-refine), add."""
    import reference_numpy as ref
    from reductive_tpu.ivf import build_ivf, ivf_add, ivf_search, train_ivf_pq

    s = sm.s
    x = sm.x_sift
    (coarse, rpq), _ = sm.timed(
        f"train_ivf_pq C={s.cells} m={s.m_sift} on {s.n}x{s.d_sift}",
        lambda: train_ivf_pq(sm.fold(7), x, s.cells, s.m_sift, s.bits,
                             coarse_iterations=5, pq_iterations=5), reps=0)
    # Coarse assignment (k = C centroids, one subquantizer of width d):
    # the encode kernel vs the plain distance matrix + argmin.
    from reductive_tpu.ivf import _coarse_topk
    from reductive_tpu.ops import assign

    for d_c in (s.d_sift, s.d_emb):
        xc = clustered(sm.fold(20 + d_c), min(s.n, 1 << 18), d_c)
        cc = xc[: s.cells] + 0.01
        ka, t_k = sm.timed(f"coarse assign kernel {xc.shape[0]}x{d_c}, C={s.cells}",
                           jax.jit(assign.assign_nearest), cc, xc, rows=xc.shape[0])
        kp, t_p = sm.timed(f"coarse assign plain XLA {xc.shape[0]}x{d_c}, C={s.cells}",
                           jax.jit(lambda c, v: _coarse_topk(v, c, 1)[:, 0]), cc, xc,
                           rows=xc.shape[0])
        sm.check(f"coarse assign d={d_c}: kernel vs plain agreement", agreement(ka, kp),
                 0.999, at_least=True, precision="TF32x3 dots vs f32 highest")
        print(f"  A/B coarse assign d={d_c}: kernel {t_k * 1e3:.3f} ms vs plain "
              f"{t_p * 1e3:.3f} ms", flush=True)
    # capacity=None (built on device): every row once, in its nearest
    # cell, cells in corpus order; the sample's codes and norms against
    # numpy.
    index0, _ = sm.timed(f"build_ivf capacity=None {s.n} rows",
                         lambda: build_ivf(coarse, rpq, x), reps=2, rows=s.n)
    ids0 = np.asarray(index0.cell_ids)
    cidx, lidx = np.nonzero(ids0 >= 0)
    stored = ids0[cidx, lidx]
    sm.check("build_ivf capacity=None: rows stored exactly once",
             float(np.mean(np.bincount(stored, minlength=s.n) == 1)), 1.0,
             at_least=True, precision="count")
    same = cidx[1:] == cidx[:-1]
    sm.check("build_ivf capacity=None: ids ascending within each cell",
             float(np.all(stored[1:][same] > stored[:-1][same])), 1.0,
             at_least=True, precision="count")
    row_cell, row_slot = np.empty(s.n, np.int64), np.empty(s.n, np.int64)
    row_cell[stored], row_slot[stored] = cidx, lidx
    smp, cn = sm.sample_idx, np.asarray(coarse)
    xs = np.asarray(x[jnp.asarray(smp)])
    dist = ref.squared_euclidean_distance(xs, cn)
    best = dist.min(axis=1)
    got = dist[np.arange(smp.size), row_cell[smp]]
    sm.check("build_ivf capacity=None: sample rows in their numpy-nearest "
             "cell (ties to 1e-4 relative)",
             float(np.mean(got <= best + 1e-4 * np.maximum(np.abs(best), 1))),
             1.0, at_least=True, precision="f32 highest vs numpy f32")
    codes0 = np.asarray(index0.cell_codes)[row_cell[smp], row_slot[smp]]
    sm.check("build_ivf capacity=None: sample residual codes agreement with numpy",
             agreement(codes0, ref.quantize_batch(np.asarray(rpq.codebooks),
                                                  xs - cn[row_cell[smp]])),
             0.999, at_least=True, precision="TF32x3 dots vs numpy f32")
    full = cn[row_cell[smp]] + ref.reconstruct_batch(np.asarray(rpq.codebooks),
                                                     codes0)
    want = np.sum(full * full, axis=1)
    norms0 = np.asarray(index0.cell_norms)[row_cell[smp], row_slot[smp]]
    sm.check("build_ivf capacity=None: sample norms vs numpy, max relative",
             float(np.max(np.abs(norms0 - want) / np.maximum(want, 1))), 1e-5,
             at_least=False, precision="f32 highest vs numpy f32")
    del index0, ids0, dist
    index, _ = sm.timed(f"build_ivf capacity=auto {s.n} rows",
                        lambda: build_ivf(coarse, rpq, x, capacity="auto"), reps=0)
    sm.check("build_ivf dropped rows", float(index.dropped_ids.size), 0,
             at_least=False, precision="count")
    q = x[:: max(1, s.n // s.nq)][: s.nq] + 0.1 * jax.random.normal(
        sm.fold(8), (s.nq, s.d_sift))
    qn, xn = np.asarray(q), np.asarray(x)
    exact = np.argpartition(ref.squared_euclidean_distance(qn, xn), 10, axis=1)[:, :10]
    cell_codes, cell_ids = np.asarray(index.cell_codes), np.asarray(index.cell_ids)
    row_cell = np.full(s.n, -1)
    row_code = np.zeros((s.n, s.m_sift), np.int64)
    cidx, lidx = np.nonzero(cell_ids >= 0)
    row_cell[cell_ids[cidx, lidx]] = cidx
    row_code[cell_ids[cidx, lidx]] = cell_codes[cidx, lidx]
    cb, cc = np.asarray(rpq.codebooks), np.asarray(coarse)
    for nprobe in (8, 32):
        for refine in (False, True):
            kw = {"refine_with": x} if refine else {}
            tag = f"ivf_search nprobe={nprobe}{' refine' if refine else ''}"
            (d, i), _ = sm.timed(f"{tag} nq={s.nq} top-10",
                                 lambda: ivf_search(index, q, 10, nprobe=nprobe, **kw))
            i = np.asarray(i)
            recall = np.mean([len(set(i[r]) & set(exact[r])) / 10 for r in range(s.nq)])
            print(f"  {tag}: recall@10 vs exact = {recall:.4f}", flush=True)
            ok = i >= 0
            rows = np.where(ok, i, 0)
            if refine:  # exact distances to the original rows
                vec = xn[rows]
            else:  # IVFADC: distances to centroid + residual reconstruction
                vec = cc[row_cell[rows]] + ref.reconstruct_batch(
                    cb, row_code[rows].reshape(-1, s.m_sift)).reshape(s.nq, 10, -1)
            want = np.sum((vec - qn[:, None, :]) ** 2, axis=-1)
            err = np.abs(np.asarray(d) - want)[ok] / np.maximum(np.abs(want[ok]), 1)
            sm.check(f"{tag}: returned distances vs numpy IVFADC, max relative",
                     float(err.max()), 1e-4, at_least=False,
                     precision="f32 decomposition vs numpy f32")
            if not refine:
                # Against the plain decode path: every id the kernel path
                # returns lies within the plain path's top-10 radius.  Ids
                # are not compared position by position: two rows whose
                # distances tie to f32 rounding may come in either order.
                dp, ip = ivf_search(index, q, 10, nprobe=nprobe, use_kernel=False)
                tie_report(f"{tag} vs plain decode path", i, d, ip, dp)
                kth = np.asarray(dp)[:, -1:]
                sm.check(f"{tag}: returned rows' numpy distances beyond the plain "
                         "path's 10th distance, max relative",
                         float(np.max((want - kth)[ok] / np.maximum(np.abs(kth), 1)
                                      .repeat(10, 1)[ok])), 1e-4, at_least=False,
                         precision="f32 table sums vs f32 gather-decode")
    x_new = clustered(sm.fold(9), s.add, s.d_sift, centers_key=sm.fold(100))
    index2, _ = sm.timed(f"ivf_add {s.add} rows", lambda: ivf_add(index, x_new), reps=0)
    ids2 = np.asarray(index2.cell_ids)
    stored = np.bincount(ids2[ids2 >= 0], minlength=s.n + s.add)
    sm.check("ivf_add: rows stored exactly once (old and new ids)",
             float(np.mean(stored == 1)), 1.0, at_least=True, precision="count")
    dk, ik = ivf_search(index2, x_new[:s.nq], 10, nprobe=8)
    dp, ip = ivf_search(index2, x_new[:s.nq], 10, nprobe=8, use_kernel=False)
    tie_report("ivf_add: search of added rows vs plain path", ik, dk, ip, dp)
    dk, dp = np.asarray(dk), np.asarray(dp)
    sm.check("ivf_add: search of added rows, distances vs the plain path, max relative",
             float(np.max(np.abs(dk - dp) / np.maximum(np.abs(dp), 1))), 1e-4,
             at_least=False, precision="f32 table sums vs f32 gather-decode")
    found = np.mean([(s.n + r) in set(np.asarray(ik)[r]) for r in range(s.nq)])
    print(f"  ivf_add: added rows found in their own top-10 = {found:.4f}", flush=True)


def phase_four(sm: Smoke, devices):
    """Sharded forms over a 1-D data mesh of four devices vs one device."""
    from reductive_tpu import train_pq_chunked
    from reductive_tpu.dispatch import encode, use_kernel
    from reductive_tpu.ivf import build_ivf, ivf_search, ivf_search_sharded, train_ivf_pq
    from reductive_tpu.parallel import (
        encode_sharded, make_mesh, train_pq_chunked_sharded,
    )
    from reductive_tpu.search import search, search_sharded

    s = sm.s
    mesh = make_mesh(devices=devices)
    m = s.m_sift
    x = clustered(sm.fold(11), s.n - s.n % len(devices), s.d_sift)
    train_sh = functools.partial(train_pq_chunked_sharded, sm.fold(12), x, m,
                                 s.bits, mesh=mesh, chunk=s.chunk)
    train_1 = functools.partial(train_pq_chunked, sm.fold(12), x, m, s.bits,
                                chunk=s.chunk)
    pq_sh, _ = sm.timed(f"train_pq_chunked_sharded {x.shape[0]}x{s.d_sift} on "
                        f"{len(devices)} devices, {s.pq_iters} iters",
                        lambda: train_sh(s.pq_iters), reps=0)
    pq_1, _ = sm.timed(f"train_pq_chunked {x.shape[0]}x{s.d_sift} on one device, "
                       f"{s.pq_iters} iters", lambda: train_1(s.pq_iters), reps=0)
    # Each form is deterministic per key: a second run gives the same bits.
    sm.check("train_pq_chunked_sharded twice from one key: bit-equal share",
             bit_agreement(train_sh(s.pq_iters).codebooks, pq_sh.codebooks), 1.0,
             at_least=True, precision="f32, sorted segment sums + psum")
    sm.check("train_pq_chunked (one device) twice from one key: bit-equal share",
             bit_agreement(train_1(s.pq_iters).codebooks, pq_1.codebooks), 1.0,
             at_least=True, precision="f32, sorted segment sums")
    # One Lloyd's step from the same initial codebooks: the psum'd
    # statistics equal the single-device ones up to f32 summation order.
    close = float(jnp.mean(jnp.isclose(train_sh(1).codebooks, train_1(1).codebooks,
                                       rtol=1e-4, atol=1e-4)))
    sm.check("one sharded Lloyd's step vs single-device: codebook entries "
             "within 1e-4", close, 0.999, at_least=True,
             precision="f32 psum of per-shard sums")
    # Over several steps the psum's summation order, different from one
    # device's, can flip a near-tie assignment and the two runs part
    # slightly; the objective must not.
    close = float(jnp.mean(jnp.isclose(pq_sh.codebooks, pq_1.codebooks,
                                       rtol=1e-4, atol=1e-4)))
    print(f"  {s.pq_iters}-iteration codebooks, sharded vs single-device: "
          f"{close:.7f} of entries within 1e-4 (reported, not checked)", flush=True)
    xs = x[jnp.asarray(sm.sample_idx[sm.sample_idx < x.shape[0]])]

    def mse(pq):
        return float(jnp.mean((xs - pq.reconstruct_batch(pq.quantize_batch(xs))) ** 2))

    ms, m1 = mse(pq_sh), mse(pq_1)
    sm.check(f"{s.pq_iters}-iteration sample MSE, sharded vs single-device, "
             "relative", abs(ms - m1) / m1, 1e-3, at_least=False,
             precision="f32, einsum encode for the MSE")
    from jax.sharding import NamedSharding, PartitionSpec

    x_sh = jax.device_put(x, NamedSharding(mesh, PartitionSpec("data", None)))
    codes_sh, _ = sm.timed(f"encode_sharded {x.shape[0]} rows (input already sharded)",
                           lambda: encode_sharded(pq_1, x_sh, mesh=mesh),
                           rows=x.shape[0])
    shards = codes_sh.addressable_shards
    sizes = sorted((sh.device.id, sh.data.shape[0]) for sh in shards)
    print(f"  encode_sharded placement (device id, rows): {sizes}", flush=True)
    sm.check("encode_sharded devices holding an equal share of rows",
             float(len({d for d, r in sizes if r == x.shape[0] // len(devices)})),
             len(devices), at_least=True, precision="count")
    codes_1 = encode(pq_1.codebooks, x, use_kernel=use_kernel("encode"))
    sm.check("encode_sharded codes equal to single-device encode",
             agreement(codes_sh, codes_1), 1.0, at_least=True, precision="same kernel per row")
    q = clustered(sm.fold(13), s.nq, s.d_sift)
    (dsh, ish), _ = sm.timed(f"search_sharded nq={s.nq} over {x.shape[0]}",
                             lambda: search_sharded(pq_1, q, codes_1, 10, mesh=mesh))
    d1, i1 = search(pq_1, q, codes_1, 10)
    sm.check("search_sharded ids equal to single-device search",
             agreement(ish, i1), 0.999, at_least=True, precision="f32 table sums")
    coarse, rpq = train_ivf_pq(sm.fold(14), x, s.cells, m, s.bits,
                               coarse_iterations=3, pq_iterations=3)
    index = build_ivf(coarse, rpq, x, capacity="auto")
    (dsh, _), _ = sm.timed(f"ivf_search_sharded nprobe=8 nq={s.nq}",
                           lambda: ivf_search_sharded(index, q, 10, nprobe=8, mesh=mesh))
    d1, _ = ivf_search(index, q, 10, nprobe=8)
    sm.check("ivf_search_sharded superset property: share of k-th distances "
             "<= single-device (+1e-5 relative)",
             float(np.mean(np.asarray(dsh) <= np.asarray(d1) * (1 + 1e-5) + 1e-4)),
             1.0, at_least=True, precision="f32, coarse matmul shapes differ")


# --------------------------------------------------------------------------


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out


def _interpret_kernels():
    """Rehearsal only: run the kernels in the Pallas interpreter and let
    the dispatch pick them as it would on a GPU."""
    from reductive_tpu import dispatch
    from reductive_tpu.ops import adc, assign

    assign.pq_encode = functools.partial(assign.pq_encode, interpret=True)
    adc.adc_scores_kernel = functools.partial(adc.adc_scores_kernel, interpret=True)
    dispatch.jax = type("RehearsalJax", (), {"default_backend": staticmethod(lambda: "gpu")})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--rehearse", action="store_true",
                    help="toy sizes on the CPU, kernels interpreted; no result line")
    args = ap.parse_args(argv)

    from reductive_tpu.utils import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    dev = devices[0]
    print(f"device: platform={dev.platform} kind={dev.device_kind} count={len(devices)}",
          flush=True)
    if dev.platform != "gpu" and not args.rehearse:
        print("chip_smoke: no GPU found (JAX platform "
              f"{dev.platform!r}); nothing was measured", file=sys.stderr)
        return 2
    card = card_line() if not args.rehearse else "CPU rehearsal"
    print(f"card: {card}", flush=True)
    if args.rehearse:
        _interpret_kernels()
    sm = Smoke(REHEARSAL if args.rehearse else Sizes(), args.seed,
               card.split(",")[0])

    if args.four:
        if len(devices) < 4:
            print(f"chip_smoke --four: needs 4 devices, found {len(devices)}",
                  file=sys.stderr)
            return 2
        phases = [("four", functools.partial(phase_four, devices=devices[:4]))]
    else:
        phases = [("pq", phase_pq), ("opq", phase_opq), ("search", phase_search),
                  ("ivf", phase_ivf)]
    for name, fn in phases:
        print(f"phase {name}:", flush=True)
        t0 = time.perf_counter()
        try:
            fn(sm)
        except Exception:  # a failed phase is reported, then fails the run
            traceback.print_exc()
            sm.failures.append(name)
        print(f"phase {name}: {'FAILED' if name in sm.failures else 'ok'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if sm.failures:
        print(f"chip_smoke: failed phases: {sm.failures}", file=sys.stderr)
        return 1
    if args.rehearse:
        print("chip_smoke: rehearsal passed (CPU, toy sizes); no result line")
        return 0
    count = 4 if args.four else len(devices)
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

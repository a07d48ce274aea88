"""Randomized cross-path consistency: every compute path must agree.

For a spread of irregular shapes (odd n, non-power-of-two k, ds below
or not a multiple of the kernel's 16-deep dot, m=1, tails smaller than
one block), the interpret-mode kernels must agree with the einsum
oracles, the packed paths with the unpacked ones, and the chunked
trainers with the in-memory step.  Seeded — failures reproduce exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from reductive_tpu import Pq
from reductive_tpu.ops import pq_encode
from reductive_tpu.pq import primitives
from reductive_tpu.pq.train import _chunk_stats

CONFIGS = [
    # (n, m, k, ds) — deliberately awkward shapes
    (513, 1, 7, 3),
    (129, 2, 17, 5),
    (1000, 3, 33, 2),
    (257, 6, 9, 1),
    (64, 4, 64, 8),
]


@pytest.mark.parametrize("n,m,k,ds", CONFIGS)
def test_encode_decode_stats_agree(n, m, k, ds):
    kx, kc = jax.random.split(jax.random.PRNGKey(n * 31 + m * 7 + k))
    x = jax.random.normal(kx, (n, m * ds), dtype=jnp.float32)
    cb = jax.random.normal(kc, (m, k, ds), dtype=jnp.float32)

    # Encode: interpret-mode kernel vs einsum oracle (random data has no
    # exact ties, so every code agrees).
    codes_k = pq_encode(cb, x, dtype=jnp.int32, interpret=True)
    codes_e = primitives.quantize_batch(cb, x, dtype=jnp.int32)
    np.testing.assert_array_equal(np.asarray(codes_k), np.asarray(codes_e))

    # Decode: the gather returns codebook rows verbatim.
    rec = np.asarray(primitives.reconstruct_batch(cb, codes_e))
    for j in range(m):
        np.testing.assert_array_equal(
            rec[:, j * ds:(j + 1) * ds], np.asarray(cb[j])[np.asarray(codes_e[:, j])]
        )

    # Stats: counts exact, sums to float tolerance, consistent with the
    # assignments.
    sums, counts = _chunk_stats(cb, x, use_kernel=False)
    onehot = jax.nn.one_hot(codes_e.T, k, dtype=jnp.float32)
    xs_m = jnp.moveaxis(x.reshape(n, m, ds), 1, 0)
    np.testing.assert_array_equal(
        np.asarray(counts), np.asarray(jnp.sum(onehot, axis=1))
    )
    ref_sums = jnp.einsum("mck,mcs->mks", onehot, xs_m, precision="highest")
    np.testing.assert_allclose(
        np.asarray(sums), np.asarray(ref_sums), rtol=1e-5, atol=1e-4
    )


@pytest.mark.parametrize("n,m,k,ds", [(300, 4, 16, 3), (77, 2, 16, 6)])
def test_adc_and_packed_agree(n, m, k, ds):
    from reductive_tpu.ops import pack_u4_codes
    from reductive_tpu.ops.adc import adc_scores_kernel
    from reductive_tpu.search import adc_scores, adc_tables

    kx, kc, kq = jax.random.split(jax.random.PRNGKey(n + m), 3)
    pq = Pq(codebooks=jax.random.normal(kc, (m, k, ds), dtype=jnp.float32))
    codes = jax.random.randint(kx, (n, m), 0, k).astype(jnp.uint8)
    queries = jax.random.normal(kq, (3, m * ds), dtype=jnp.float32)

    tables = adc_tables(pq, queries)
    ref = adc_scores(tables, codes, chunk_size=64)
    got = adc_scores_kernel(tables, codes, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-4)
    if k <= 16 and m % 2 == 0:
        packed = pack_u4_codes(codes)
        got_p = adc_scores_kernel(tables, packed, packed=True, interpret=True)
        np.testing.assert_allclose(np.asarray(got_p), np.asarray(got),
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_ivf_add_remove_sequences(seed):
    """Random interleavings of ivf_remove/ivf_add must preserve the index
    invariants (unique live ids, one slot each) and end search-equivalent
    to a fresh build over the surviving rows with the same quantizers."""
    from reductive_tpu.ivf import (
        build_ivf, ivf_add, ivf_remove, ivf_search, train_ivf_pq,
    )

    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(100 + seed)
    d, n0 = 12, 160
    x_all = jax.random.normal(key, (400, d), dtype=jnp.float32)
    coarse, pq = train_ivf_pq(key, x_all[:n0], 6, 3, 3, use_kernel=False,
                              train_sample=None)
    # Headroom so adds never exhaust capacity mid-fuzz.
    index = build_ivf(coarse, pq, x_all[:n0], capacity=100,
                      use_kernel=False)
    live = dict(enumerate(range(n0)))  # id -> row of x_all
    next_id, next_row = n0, n0
    for _ in range(6):
        if rng.random() < 0.5 and len(live) > 10:
            victims = rng.choice(list(live), size=rng.integers(1, 8),
                                 replace=False)
            index = ivf_remove(index, victims)
            for v in victims:
                live.pop(int(v))
        else:
            b = int(rng.integers(1, 10))
            rows = list(range(next_row, next_row + b))
            ids = np.arange(next_id, next_id + b)
            index = ivf_add(index, x_all[rows[0]:rows[-1] + 1], ids=ids,
                            use_kernel=False)
            for i, r in zip(ids, rows):
                live[int(i)] = r
            next_id += b
            next_row += b

    ci = np.asarray(index.cell_ids)
    flat = ci[ci >= 0]
    assert len(flat) == len(live)
    assert set(flat.tolist()) == set(live)

    # Search equivalence to a fresh build: same quantizers, surviving
    # rows, ids mapped back through the fuzz's id -> row table.
    ids_sorted = sorted(live)
    x_live = x_all[np.asarray([live[i] for i in ids_sorted])]
    rebuilt = build_ivf(coarse, pq, x_live, capacity=100, use_kernel=False)
    q = x_all[:7]
    d_a, i_a = ivf_search(index, q, top_k=5, nprobe=6, use_kernel=False)
    d_r, i_r = ivf_search(rebuilt, q, top_k=5, nprobe=6, use_kernel=False)
    np.testing.assert_allclose(np.asarray(d_a), np.asarray(d_r),
                               rtol=1e-4, atol=1e-4)
    # Ids map: rebuilt index numbers rows 0..len-1 in ids_sorted order.
    mapped = np.asarray(ids_sorted, dtype=np.int64)[np.asarray(i_r)]
    # Equal-distance ties can permute; compare per-query as sets.
    for qi in range(q.shape[0]):
        assert set(np.asarray(i_a)[qi].tolist()) == set(mapped[qi].tolist())

"""Boundary-condition coverage: the extremes the hyperparameter
invariants permit (reference: ``check_quantizer_invariants``,
``src/pq/pq.rs:63-100``) — ds=1 (m == d), bits=1 (k=2), n = k+1, m=1 —
through the trainers, the primitives, the chunked statistics and the
encode kernel (Pallas interpreter)."""

import numpy as np

import jax
import jax.numpy as jnp

from reductive_tpu import Pq, train_opq, train_pq, train_pq_chunked
from reductive_tpu.ops import pq_encode
from reductive_tpu.pq import primitives
from reductive_tpu.pq.train import _chunk_stats


def test_ds1_every_dimension_its_own_subquantizer():
    m, k, n = 8, 4, 200
    x = jax.random.normal(jax.random.PRNGKey(0), (n, m), dtype=jnp.float32)
    cb = jax.random.normal(jax.random.PRNGKey(1), (m, k, 1), dtype=jnp.float32)
    codes = primitives.quantize_batch(cb, x, dtype=jnp.uint8)
    ck = pq_encode(cb, x, dtype=jnp.uint8, interpret=True)
    np.testing.assert_array_equal(np.asarray(ck), np.asarray(codes))
    _, counts = _chunk_stats(cb, x, use_kernel=False)
    assert float(jnp.sum(counts)) == n * m
    rec = primitives.reconstruct_batch(cb, ck)
    np.testing.assert_array_equal(np.asarray(rec[:, 0]),
                                  np.asarray(cb[0, ck[:, 0].astype(jnp.int32), 0]))
    pq = train_pq(jax.random.PRNGKey(2), x, m, 2, 5, 1)
    assert np.isfinite(np.asarray(pq.codebooks)).all()


def test_bits1_two_centroids():
    x = jax.random.uniform(jax.random.PRNGKey(0), (64, 8), dtype=jnp.float32)
    pq = train_pq(jax.random.PRNGKey(1), x, 4, 1, 5, 2)
    assert int(pq.quantize_batch(x).max()) <= 1
    pq2 = train_opq(jax.random.PRNGKey(2), x, 4, 1, 3)
    assert np.isfinite(np.asarray(pq2.codebooks)).all()


def test_minimum_corpus_n_equals_k_plus_one():
    x = jax.random.uniform(jax.random.PRNGKey(0), (5, 4), dtype=jnp.float32)
    pq = train_pq(jax.random.PRNGKey(1), x, 2, 2, 3, 1)
    assert np.isfinite(np.asarray(pq.codebooks)).all()
    pqc = train_pq_chunked(
        jax.random.PRNGKey(1), x, 2, 2, 3, 1, chunk=2, use_kernel=False
    )
    assert np.isfinite(np.asarray(pqc.codebooks)).all()


def test_single_subquantizer_is_plain_vq():
    x = jax.random.uniform(jax.random.PRNGKey(0), (100, 8), dtype=jnp.float32)
    pq = train_pq(jax.random.PRNGKey(1), x, 1, 3, 5, 1)
    codes = pq.quantize_batch(x)
    assert codes.shape == (100, 1)
    assert pq.reconstruct_batch(codes).shape == (100, 8)


def test_single_vector_roundtrip():
    pq = Pq(codebooks=jax.random.normal(jax.random.PRNGKey(0), (2, 4, 3), dtype=jnp.float32))
    v = jax.random.normal(jax.random.PRNGKey(1), (6,), dtype=jnp.float32)
    code = pq.quantize_vector(v)
    assert code.shape == (2,)
    assert pq.reconstruct(code).shape == (6,)

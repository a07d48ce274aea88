"""Tests for the chunked training path.

The in-memory Lloyd's iteration (``kmeans.kmeans_iteration`` vmapped over
the subquantizer axis) is the correctness oracle; the chunked path must
reproduce it to float tolerance.  Its statistics are a sorted segment
sum of each subvector into its (subquantizer, centroid) segment; they
must equal the one-hot matmul statistics they replaced.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from reductive_tpu import train_pq
from reductive_tpu.kmeans import kmeans_iteration
from reductive_tpu.pq import primitives
from reductive_tpu.pq.train import (
    _chunk_stats,
    lloyd_iteration_chunked,
    sorted_segment_sum,
    train_pq_chunked,
)


def onehot_stats(cb, x, codes):
    """The one-hot matmul statistics: ``onehot(codes)^T @ x`` per
    subquantizer, and the one-hot column sums."""
    n = x.shape[0]
    m, k, ds = cb.shape
    onehot = jax.nn.one_hot(codes.T, k, dtype=jnp.float32)
    xs_m = jnp.moveaxis(x.reshape(n, m, ds), 1, 0)
    sums = jnp.einsum("mck,mcs->mks", onehot, xs_m, precision="highest")
    return sums, jnp.sum(onehot, axis=1)


@pytest.mark.parametrize("n,m,k,ds", [(1000, 4, 8, 4), (257, 2, 3, 5)])
def test_sorted_segment_stats_match_onehot(n, m, k, ds):
    """Sorted-segment-sum statistics equal the one-hot matmul statistics."""
    kx, kc = jax.random.split(jax.random.PRNGKey(0))
    x = jax.random.normal(kx, (n, m * ds), dtype=jnp.float32)
    cb = jax.random.normal(kc, (m, k, ds), dtype=jnp.float32)

    sums, counts = _chunk_stats(cb, x, use_kernel=False)
    codes = primitives.quantize_batch(cb, x, dtype=jnp.int32)
    ref_sums, ref_counts = onehot_stats(cb, x, codes)

    assert float(jnp.sum(counts)) == n * m
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ref_counts))
    np.testing.assert_allclose(
        np.asarray(sums), np.asarray(ref_sums), rtol=1e-5, atol=1e-4
    )


def test_chunk_stats_follow_encode_kernel_codes(interpret_kernels):
    """On the kernel path the statistics are those of the encode
    kernel's assignments, exactly."""
    from reductive_tpu.ops import assign

    n, m, k, ds = 2000, 8, 64, 4
    kx, kc = jax.random.split(jax.random.PRNGKey(1))
    x = jax.random.normal(kx, (n, m * ds), dtype=jnp.float32)
    cb = jax.random.normal(kc, (m, k, ds), dtype=jnp.float32)

    sums, counts = _chunk_stats(cb, x, use_kernel=True)
    codes = assign.pq_encode(cb, x, dtype=jnp.int32)
    ref_sums, ref_counts = onehot_stats(cb, x, codes)

    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ref_counts))
    np.testing.assert_allclose(
        np.asarray(sums), np.asarray(ref_sums), rtol=1e-5, atol=1e-4
    )


@pytest.mark.parametrize("n,segments,w", [(1, 3, 2), (500, 7, 3), (4000, 600, 9)])
def test_sorted_segment_sum_matches_numpy(n, segments, w):
    """Per-segment sums (in f64 numpy, f32 tolerance) and exact counts;
    segments no row falls in sum to zero; repeated calls give the same
    bits."""
    rng = np.random.default_rng(n)
    values = rng.standard_normal((n, w)).astype(np.float32)
    segment = rng.integers(0, max(1, segments - 2), size=n).astype(np.int32)
    f = jax.jit(sorted_segment_sum, static_argnums=2)
    sums, counts = f(jnp.asarray(values), jnp.asarray(segment), segments)
    want = np.zeros((segments, w))
    np.add.at(want, segment, values.astype(np.float64))
    np.testing.assert_array_equal(np.asarray(counts),
                                  np.bincount(segment, minlength=segments))
    np.testing.assert_allclose(np.asarray(sums), want, rtol=1e-5, atol=1e-5)
    assert not np.asarray(sums)[segments - 2:].any()
    again, _ = f(jnp.asarray(values), jnp.asarray(segment), segments)
    np.testing.assert_array_equal(np.asarray(again).view(np.uint32),
                                  np.asarray(sums).view(np.uint32))


@pytest.mark.parametrize("chunk", [256, 1000, 4096])
def test_chunked_iteration_matches_in_memory(chunk):
    n, m, k, ds = 1000, 4, 8, 4
    x = jax.random.uniform(jax.random.PRNGKey(0), (n, m * ds), dtype=jnp.float32)
    cb = jax.random.normal(jax.random.PRNGKey(1), (m, k, ds), dtype=jnp.float32)
    sumsq = jnp.sum(x.reshape(n, m, ds) ** 2, axis=(0, 2))

    new_cb, loss = lloyd_iteration_chunked(
        x, cb, sumsq, chunk=chunk, use_kernel=False
    )
    xs_m = jnp.moveaxis(x.reshape(n, m, ds), 1, 0)
    ref_cb, ref_loss = jax.vmap(kmeans_iteration)(xs_m, cb)

    np.testing.assert_allclose(np.asarray(new_cb), np.asarray(ref_cb), atol=1e-5)
    np.testing.assert_allclose(np.asarray(loss), np.asarray(ref_loss), rtol=1e-4)


def test_chunked_iteration_empty_cluster_zero_vector():
    """Empty clusters become the zero vector, exactly like the in-memory
    update (reference semantics: src/kmeans.rs:181,194-196)."""
    x = jnp.ones((16, 4), dtype=jnp.float32)
    # One centroid at the data, one far away (never assigned).
    cb = jnp.stack(
        [jnp.stack([jnp.ones(2), jnp.full(2, 100.0)]),
         jnp.stack([jnp.ones(2), jnp.full(2, 100.0)])]
    ).astype(jnp.float32)  # (m=2, k=2, ds=2)
    sumsq = jnp.sum(x.reshape(16, 2, 2) ** 2, axis=(0, 2))
    new_cb, loss = lloyd_iteration_chunked(x, cb, sumsq, chunk=8, use_kernel=False)
    np.testing.assert_array_equal(np.asarray(new_cb[:, 1, :]), 0.0)
    np.testing.assert_array_equal(np.asarray(new_cb[:, 0, :]), 1.0)
    np.testing.assert_allclose(np.asarray(loss), 0.0, atol=1e-6)


def test_train_pq_chunked_quality_and_attempts():
    """Chunked training reaches the same quality as the in-memory trainer
    on the reference's gate scenario, and attempts keep the best."""
    key = jax.random.PRNGKey(42)
    x = jax.random.uniform(key, (256, 20), dtype=jnp.float32)
    pq = train_pq_chunked(key, x, 10, 7, 10, 2, chunk=64, use_kernel=False)
    rec = pq.reconstruct_batch(pq.quantize_batch(x))
    loss = float(jnp.mean(jnp.sqrt(jnp.sum((x - rec) ** 2, axis=1))))
    assert loss < 0.08  # the reference Pq gate

    ref = train_pq(key, x, 10, 7, 10, 2)
    rec2 = ref.reconstruct_batch(ref.quantize_batch(x))
    ref_loss = float(jnp.mean(jnp.sqrt(jnp.sum((x - rec2) ** 2, axis=1))))
    assert abs(loss - ref_loss) < 0.01


def test_train_pq_chunked_validates_hyperparams():
    from reductive_tpu import errors

    x = jnp.ones((32, 8))
    with pytest.raises(errors.ReductiveError):
        train_pq_chunked(jax.random.PRNGKey(0), x, 3, 2, 5, 1, use_kernel=False)


def test_train_opq_chunked_quality_gate():
    """Chunked OPQ passes the reference's Opq gate (<0.1) on the seeded
    scenario, with an orthonormal learned projection."""
    from reductive_tpu import train_opq_chunked

    key = jax.random.PRNGKey(42)
    x = jax.random.uniform(key, (256, 20), dtype=jnp.float32)
    pq = train_opq_chunked(key, x, 10, 7, 10, chunk=64, use_kernel=False)
    rec = pq.reconstruct_batch(pq.quantize_batch(x))
    loss = float(jnp.mean(jnp.sqrt(jnp.sum((x - rec) ** 2, axis=1))))
    assert loss < 0.1
    R = np.asarray(pq.projection)
    np.testing.assert_allclose(R.T @ R, np.eye(20), atol=1e-4)


def test_train_gaussian_opq_chunked_quality_gate():
    from reductive_tpu import train_gaussian_opq_chunked

    key = jax.random.PRNGKey(42)
    x = jax.random.uniform(key, (256, 20), dtype=jnp.float32)
    pq = train_gaussian_opq_chunked(key, x, 10, 7, 10, chunk=64, use_kernel=False)
    rec = pq.reconstruct_batch(pq.quantize_batch(x))
    loss = float(jnp.mean(jnp.sqrt(jnp.sum((x - rec) ** 2, axis=1))))
    assert loss < 0.12


def test_chunked_stats_exact_for_bf16_corpus():
    """Statistics stay f32 even when the corpus is bfloat16: counts are
    exact integers and sums are f32-accumulated (regression: stats used to
    be cast to the corpus dtype, corrupting counts > 256 in bf16)."""
    from reductive_tpu.pq.train import assign_stats_streamed

    n, m, k, ds = 3000, 2, 2, 4
    x = jax.random.normal(jax.random.PRNGKey(0), (n, m * ds), jnp.float32)
    xb = x.astype(jnp.bfloat16)
    cb = jax.random.normal(jax.random.PRNGKey(1), (m, k, ds), jnp.float32)

    sums, counts = assign_stats_streamed(
        xb, cb.astype(jnp.bfloat16), chunk=500, use_kernel=False,
    )
    assert sums.dtype == jnp.float32 and counts.dtype == jnp.float32
    # Counts are exact: integral and summing to n per subquantizer.
    assert float(jnp.sum(counts)) == n * m
    np.testing.assert_array_equal(np.asarray(counts), np.round(np.asarray(counts)))
    # With k=2 clusters of ~1500 members each, bf16-cast counts would have
    # quantized to multiples of 8 — check at least one count is not.
    assert counts.max() > 256


def test_train_gaussian_opq_chunked_never_materializes_rotation():
    """The projection flows through train_pq_chunked chunk-by-chunk; the
    result matches training on an explicitly rotated corpus."""
    from reductive_tpu import train_gaussian_opq_chunked
    from reductive_tpu.pq.opq import create_projection_matrix
    from reductive_tpu.pq.train import train_pq_chunked

    key = jax.random.PRNGKey(42)
    x = jax.random.uniform(key, (128, 8), dtype=jnp.float32)
    pq = train_gaussian_opq_chunked(key, x, 4, 3, 5, chunk=32, use_kernel=False)

    R = create_projection_matrix(x, 4)
    rx = jnp.dot(x, R, precision="highest")
    ref = train_pq_chunked(key, rx, 4, 3, 5, chunk=32, use_kernel=False)
    np.testing.assert_allclose(
        np.asarray(pq.codebooks), np.asarray(ref.codebooks), atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(pq.projection), np.asarray(R))


def test_kmeans_chunked_rejects_zero_iterations():
    from reductive_tpu.kmeans import kmeans_with_centroids_chunked

    x = jnp.ones((10, 4))
    with pytest.raises(ValueError, match="must be >= 1"):
        kmeans_with_centroids_chunked(x, x[:2], 0, use_kernel=False)


def test_search_rejects_unknown_method():
    from reductive_tpu import Pq
    from reductive_tpu.search import search

    pq = Pq(codebooks=jnp.ones((2, 2, 2)))
    with pytest.raises(ValueError, match="unknown search method"):
        search(pq, jnp.ones((1, 4)), jnp.zeros((5, 2), jnp.int32), top_k=1,
               method="kernels")


def test_lloyd_step_kernel_equals_plain_large_k(interpret_kernels):
    """A large codebook (k=2048, several centroid tiles in the encode
    kernel): a Lloyd's step on the kernel path equals the plain path."""
    m, k, ds, n = 2, 2048, 16, 400
    x = jax.random.normal(jax.random.PRNGKey(0), (n, m * ds), dtype=jnp.float32)
    cb = jax.random.normal(jax.random.PRNGKey(1), (m, k, ds), dtype=jnp.float32)
    sumsq = jnp.sum(x.reshape(n, m, ds) ** 2, axis=(0, 2))
    cb_k, loss_k = lloyd_iteration_chunked(x, cb, sumsq, chunk=128,
                                           use_kernel=True)
    cb_p, loss_p = lloyd_iteration_chunked(x, cb, sumsq, chunk=128,
                                           use_kernel=False)
    np.testing.assert_array_equal(np.asarray(cb_k), np.asarray(cb_p))
    np.testing.assert_array_equal(np.asarray(loss_k), np.asarray(loss_p))


def test_train_pq_chunked_checkpoint_hook(tmp_path, caplog):
    """checkpoint_every on the chunked PQ trainer writes a loadable
    recovery artifact without changing the training result, and the
    per-iteration loss trajectory is logged."""
    import logging

    from reductive_tpu import io as rio
    from reductive_tpu.pq.train import train_pq_chunked

    key = jax.random.PRNGKey(3)
    x = jax.random.uniform(key, (128, 12), dtype=jnp.float32)
    path = str(tmp_path / "pq_ckpt.npz")

    plain = train_pq_chunked(key, x, 4, 3, 5, chunk=32, use_kernel=False)
    with caplog.at_level(logging.INFO, logger="reductive_tpu"):
        ckpt = train_pq_chunked(
            key, x, 4, 3, 5, chunk=32, use_kernel=False,
            checkpoint_every=2, checkpoint_path=path,
        )
        jax.effects_barrier()
    np.testing.assert_allclose(
        np.asarray(ckpt.codebooks), np.asarray(plain.codebooks),
        rtol=1e-6, atol=1e-6,
    )
    saved = rio.load(path)
    np.testing.assert_allclose(
        np.asarray(saved.codebooks), np.asarray(ckpt.codebooks),
        rtol=1e-6, atol=1e-6,
    )
    lines = [r.message for r in caplog.records if "Lloyd's iteration" in r.message]
    assert [l.split(":")[0] for l in lines] == [
        f"Lloyd's iteration {i}" for i in range(5)
    ]


def test_train_pq_chunked_resume_from_checkpoint(tmp_path):
    """A killed chunked-PQ job resumes from the checkpoint artifact and
    reproduces the uninterrupted run exactly."""
    from reductive_tpu import io as rio
    from reductive_tpu.pq.train import train_pq_chunked

    key = jax.random.PRNGKey(4)
    x = jax.random.uniform(key, (128, 12), dtype=jnp.float32)
    path = str(tmp_path / "pq_resume.npz")

    straight = train_pq_chunked(key, x, 4, 3, 6, chunk=32, use_kernel=False)
    train_pq_chunked(key, x, 4, 3, 4, chunk=32, use_kernel=False,
                     checkpoint_every=2, checkpoint_path=path)
    resumed = train_pq_chunked(
        key, x, 4, 3, 2, chunk=32, use_kernel=False,
        initial_model=rio.load(path),
    )
    np.testing.assert_array_equal(
        np.asarray(resumed.codebooks), np.asarray(straight.codebooks)
    )

    import pytest
    with pytest.raises(ValueError, match="n_attempts=1"):
        train_pq_chunked(key, x, 4, 3, 2, 2, use_kernel=False,
                         initial_model=rio.load(path))

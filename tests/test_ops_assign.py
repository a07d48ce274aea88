"""Tests for the fused encode kernel (Pallas through Triton).

Runs in Pallas interpreter mode on CPU, where the kernel's dots are plain
f32; the host numpy reference (``tests/reference_numpy.py``) and the
einsum path in ``reductive_tpu.pq.primitives`` are the oracles.  Random
data has no exact distance ties, so codes must match outright; the
``gpu``-marked test repeats the comparison with the compiled kernel
(three-pass TF32 dots) at real widths.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from reductive_tpu.kmeans import cluster_assignments
from reductive_tpu.ops import assign, pq_encode
from reductive_tpu.pq import primitives

import reference_numpy as ref_np


def chosen_distances(codebooks, x, codes):
    """Per-(row, subquantizer) squared distance of the chosen centroid."""
    m, k, ds = codebooks.shape
    xs = x.reshape(x.shape[0], m, ds)
    chosen = jnp.take_along_axis(
        codebooks[None], codes.astype(jnp.int32)[:, :, None, None], axis=2
    )[:, :, 0, :]
    return jnp.sum((xs - chosen) ** 2, axis=2)


@pytest.mark.parametrize("n,m,k,ds", [(64, 4, 16, 8), (100, 2, 8, 3), (257, 8, 32, 4)])
def test_pq_encode_near_optimal(n, m, k, ds):
    """Every chosen centroid is the nearest (the einsum oracle's code):
    the kernel's argmin is a plain f32 argmin, with no key coarsening."""
    key = jax.random.PRNGKey(0)
    kx, kc = jax.random.split(key)
    x = jax.random.normal(kx, (n, m * ds), dtype=jnp.float32)
    codebooks = jax.random.normal(kc, (m, k, ds), dtype=jnp.float32)

    exact = primitives.quantize_batch(codebooks, x, dtype=jnp.int32)
    got = pq_encode(codebooks, x, block_n=64, dtype=jnp.int32, interpret=True)
    np.testing.assert_allclose(chosen_distances(codebooks, x, got),
                               chosen_distances(codebooks, x, exact),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(exact))


@pytest.mark.parametrize("m,ds", [(1, 32), (8, 16), (16, 8), (24, 32)])
@pytest.mark.parametrize("k", [16, 256])
def test_pq_encode_matches_reference(m, k, ds):
    """m in {1, 8, 16, 24}, k in {16, 256}, ragged n (not a multiple of
    block_n): every code equals the host reference's."""
    n = 77
    key = jax.random.fold_in(jax.random.PRNGKey(0), m * 1000 + k)
    kx, kc = jax.random.split(key)
    x = jax.random.normal(kx, (n, m * ds), dtype=jnp.float32)
    codebooks = jax.random.normal(kc, (m, k, ds), dtype=jnp.float32)
    got = pq_encode(codebooks, x, block_n=32, k_tile=64, dtype=jnp.int32,
                    interpret=True)
    want = ref_np.quantize_batch(np.asarray(codebooks), np.asarray(x))
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("ds", [3, 5, 20, 48])
def test_pq_encode_any_subvector_width(ds):
    """Widths that are not a multiple of the 16-deep dot: the zero rows
    of W past ``ds`` make slabs that overrun into the next subquantizer
    (or past the end of ``x``) add nothing."""
    n, m, k = 50, 3, 24
    kx, kc = jax.random.split(jax.random.PRNGKey(ds))
    x = jax.random.normal(kx, (n, m * ds), dtype=jnp.float32)
    codebooks = jax.random.normal(kc, (m, k, ds), dtype=jnp.float32)
    got = pq_encode(codebooks, x, block_n=16, dtype=jnp.int32, interpret=True)
    want = primitives.quantize_batch(codebooks, x, dtype=jnp.int32)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.gpu
def test_pq_encode_compiled_on_gpu(gpu):
    """The compiled kernel at the SIFT1M width agrees with the f32 einsum
    on all but near-equidistant rows (three-pass TF32 dots)."""
    kx, kc = jax.random.split(jax.random.PRNGKey(7))
    x = jax.random.normal(kx, (65536, 128), dtype=jnp.float32)
    codebooks = jax.random.normal(kc, (16, 256, 8), dtype=jnp.float32)
    got = pq_encode(codebooks, x)
    want = primitives.quantize_batch(codebooks, x)
    assert float(jnp.mean(got == want)) > 0.9999


def test_pq_encode_partial_tile():
    # n not a multiple of block_n: padded columns must not corrupt output.
    key = jax.random.PRNGKey(1)
    kx, kc = jax.random.split(key)
    x = jax.random.normal(kx, (33, 8), dtype=jnp.float32)
    codebooks = jax.random.normal(kc, (2, 4, 4), dtype=jnp.float32)
    exact = primitives.quantize_batch(codebooks, x, dtype=jnp.int32)
    got = pq_encode(codebooks, x, block_n=32, dtype=jnp.int32, interpret=True)
    np.testing.assert_array_equal(got, exact)


def test_pq_encode_golden_codebook():
    # The reference's predefined-codebook truth table (src/pq/pq.rs:378-417):
    # distances are well separated, so codes must match exactly.
    codebooks = jnp.array(
        [
            [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
            [[1.0, -1.0, 0.0], [0.0, 1.0, 0.0]],
        ],
        dtype=jnp.float32,
    )
    vectors = jnp.array(
        [
            [0.0, 2.0, 0.0, -0.5, 0.0, 0.0],
            [1.0, -0.2, 0.0, 0.5, 0.5, 0.0],
            [-0.2, 0.2, 0.0, 0.0, -2.0, 0.0],
            [1.0, 0.2, 0.0, 0.0, -2.0, 0.0],
        ],
        dtype=jnp.float32,
    )
    got = pq_encode(codebooks, vectors, block_n=8, dtype=jnp.int32,
                    interpret=True)
    np.testing.assert_array_equal(got, [[1, 1], [0, 1], [1, 0], [0, 0]])


def test_pq_encode_tie_breaks_to_first_index():
    # Duplicate centroids (e.g. empty clusters that became zero vectors)
    # produce exact distance ties; the reference picks the first index
    # (src/kmeans.rs:119-125), and so must the kernel's argmin — within a
    # centroid tile and across tiles (k_tile=16 puts the duplicate of
    # centroid 0 in the second tile).
    codebooks = np.zeros((1, 20, 2), np.float32) + 9.0
    codebooks[0, 0] = codebooks[0, 2] = codebooks[0, 17] = [1.0, 1.0]
    x = jnp.array([[1.0, 1.0], [0.9, 1.1]], jnp.float32)
    got = pq_encode(jnp.asarray(codebooks), x, block_n=8, k_tile=16,
                    dtype=jnp.int32, interpret=True)
    np.testing.assert_array_equal(got, [[0], [0]])


def test_assign_nearest_matches_kmeans_assign(interpret_kernels):
    key = jax.random.PRNGKey(2)
    kx, kc = jax.random.split(key)
    x = jax.random.normal(kx, (120, 16), dtype=jnp.float32)
    centroids = jax.random.normal(kc, (10, 16), dtype=jnp.float32)
    expected = cluster_assignments(centroids, x)
    got = assign.assign_nearest(centroids, x)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))


def test_pq_encode_narrow_dtype_rejected():
    codebooks = jnp.zeros((1, 257, 4), dtype=jnp.float32)
    with pytest.raises(OverflowError):
        pq_encode(codebooks, jnp.zeros((4, 4)), dtype=jnp.uint8, interpret=True)


def test_kernels_wide_codebook_k_gt_256():
    """k > 256 runs several centroid tiles and needs uint16 codes."""
    n, m, k, ds = 400, 2, 300, 4
    kx, kc = jax.random.split(jax.random.PRNGKey(0))
    x = jax.random.normal(kx, (n, m * ds), dtype=jnp.float32)
    cb = jax.random.normal(kc, (m, k, ds), dtype=jnp.float32)

    codes = pq_encode(cb, x, dtype=jnp.uint16, interpret=True)
    assert codes.dtype == jnp.uint16
    exact = primitives.quantize_batch(cb, x, dtype=jnp.uint16)
    np.testing.assert_array_equal(np.asarray(codes), np.asarray(exact))

    # uint8 must be rejected for k > 256 (reference: primitives.rs:31-34)
    with pytest.raises(OverflowError):
        pq_encode(cb, x, dtype=jnp.uint8, interpret=True)

"""Golden-fixture and quality-gate tests for the Pq model and trainer.

Ports the reference's inline tests (reference: ``src/pq/pq.rs:350-491``):
the predefined-codebook truth tables, the narrow-dtype contract test, the
shape accessors, and the seeded statistical quality gate (avg
quantize→reconstruct Euclidean loss < 0.08 on 256x20 U(0,1), m=10, 7 bits,
10 iterations).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from reductive_tpu import Pq, train_pq
from reductive_tpu.errors import (
    IncorrectNAttempts,
    IncorrectNIterations,
    IncorrectNSubquantizerBits,
    IncorrectNumberSubquantizers,
    NSubquantizersOutsideRange,
)


def ref_vectors():
    # reference: src/pq/pq.rs:378-385
    return jnp.array(
        [
            [0.0, 2.0, 0.0, -0.5, 0.0, 0.0],
            [1.0, -0.2, 0.0, 0.5, 0.5, 0.0],
            [-0.2, 0.2, 0.0, 0.0, -2.0, 0.0],
            [1.0, 0.2, 0.0, 0.0, -2.0, 0.0],
        ],
        dtype=jnp.float32,
    )


def ref_quantizations():
    # reference: src/pq/pq.rs:387-389
    return jnp.array([[1, 1], [0, 1], [1, 0], [0, 0]])


def ref_reconstructions():
    # reference: src/pq/pq.rs:391-398
    return jnp.array(
        [
            [0.0, 1.0, 0.0, 0.0, 1.0, 0.0],
            [1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
            [0.0, 1.0, 0.0, 1.0, -1.0, 0.0],
            [1.0, 0.0, 0.0, 1.0, -1.0, 0.0],
        ],
        dtype=jnp.float32,
    )


def make_test_pq():
    # reference: src/pq/pq.rs:400-407
    codebooks = jnp.array(
        [
            [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
            [[1.0, -1.0, 0.0], [0.0, 1.0, 0.0]],
        ],
        dtype=jnp.float32,
    )
    return Pq(codebooks=codebooks)


def avg_euclidean_loss(instances, pq):
    """Mean Euclidean distance between instances and their
    quantize→reconstruct roundtrip (reference: ``src/pq/pq.rs:365-376``)."""
    codes = pq.quantize_batch(instances, dtype=jnp.uint8)
    reconstructions = pq.reconstruct_batch(codes)
    dists = jnp.sqrt(jnp.sum((instances - reconstructions) ** 2, axis=1))
    return float(jnp.mean(dists))


def test_quantize_batch_with_predefined_codebook():
    # reference: src/pq/pq.rs:409-417
    pq = make_test_pq()
    np.testing.assert_array_equal(
        pq.quantize_batch(ref_vectors(), dtype=jnp.int32), ref_quantizations()
    )


def test_quantize_with_predefined_codebook():
    # reference: src/pq/pq.rs:419-429
    pq = make_test_pq()
    for vector, quantization in zip(ref_vectors(), ref_quantizations()):
        np.testing.assert_array_equal(
            pq.quantize_vector(vector, dtype=jnp.int32), quantization
        )


def test_quantize_with_pq():
    # reference: src/pq/pq.rs:431-440 — statistical quality gate, loss is
    # around 0.077 with k=128 codebooks over 256 uniform instances.
    key = jax.random.PRNGKey(42)
    data_key, train_key = jax.random.split(key)
    instances = jax.random.uniform(data_key, (256, 20), dtype=jnp.float32)
    pq = train_pq(train_key, instances, 10, 7, 10, 1)
    loss = avg_euclidean_loss(instances, pq)
    assert loss < 0.08, f"loss {loss} not under reference gate 0.08"


def test_quantize_with_type():
    # reference: src/pq/pq.rs:442-450 — k=256 exactly fits u8.
    key = jax.random.PRNGKey(0)
    pq = Pq(codebooks=jax.random.uniform(key, (1, 256, 10), dtype=jnp.float32))
    codes = pq.quantize_vector(jax.random.uniform(key, (10,)), dtype=jnp.uint8)
    assert codes.dtype == jnp.uint8


def test_quantize_with_too_narrow_type():
    # reference: src/pq/pq.rs:452-461 — k=257 must not fit u8.
    key = jax.random.PRNGKey(0)
    pq = Pq(codebooks=jax.random.uniform(key, (1, 257, 10), dtype=jnp.float32))
    with pytest.raises(OverflowError, match="Cannot store centroids"):
        pq.quantize_vector(jax.random.uniform(key, (10,)), dtype=jnp.uint8)


def test_quantizer_lens():
    # reference: src/pq/pq.rs:463-469
    pq = make_test_pq()
    assert pq.quantized_len == 2
    assert pq.reconstructed_len == 6
    assert pq.n_quantizer_centroids == 2
    assert pq.n_subquantizers == 2


def test_reconstruct_batch_with_predefined_codebook():
    # reference: src/pq/pq.rs:471-478
    pq = make_test_pq()
    np.testing.assert_array_equal(
        pq.reconstruct_batch(ref_quantizations()), ref_reconstructions()
    )


def test_reconstruct_with_predefined_codebook():
    # reference: src/pq/pq.rs:480-490
    pq = make_test_pq()
    for quantization, reconstruction in zip(ref_quantizations(), ref_reconstructions()):
        np.testing.assert_array_equal(pq.reconstruct(quantization), reconstruction)


def test_pq_is_a_pytree():
    pq = make_test_pq()
    leaves = jax.tree_util.tree_leaves(pq)
    assert len(leaves) == 1  # codebooks only; projection is None

    roundtrip = jax.jit(lambda p: p)(pq)
    np.testing.assert_array_equal(roundtrip.codebooks, pq.codebooks)


def test_pq_constructor_validation():
    with pytest.raises(ValueError, match="without quantizers"):
        Pq(codebooks=jnp.zeros((0, 2, 3)))
    with pytest.raises(ValueError, match="projection matrix shape"):
        Pq(codebooks=jnp.zeros((2, 2, 3)), projection=jnp.zeros((4, 4)))


def test_train_validation():
    x = jnp.zeros((16, 8))
    key = jax.random.PRNGKey(0)
    with pytest.raises(NSubquantizersOutsideRange):
        train_pq(key, x, 0, 2, 1, 1)
    with pytest.raises(NSubquantizersOutsideRange):
        train_pq(key, x, 9, 2, 1, 1)
    with pytest.raises(IncorrectNSubquantizerBits):
        train_pq(key, x, 4, 0, 1, 1)
    with pytest.raises(IncorrectNSubquantizerBits):
        train_pq(key, x, 4, 5, 1, 1)  # max bits = log2(16) = 4
    with pytest.raises(IncorrectNumberSubquantizers):
        train_pq(key, x, 3, 2, 1, 1)
    with pytest.raises(IncorrectNIterations):
        train_pq(key, x, 4, 2, 0, 1)
    with pytest.raises(IncorrectNAttempts):
        train_pq(key, x, 4, 2, 1, 0)


def test_train_with_attempts_not_worse():
    key = jax.random.PRNGKey(1)
    data_key, k1, k2 = jax.random.split(key, 3)
    instances = jax.random.uniform(data_key, (128, 8), dtype=jnp.float32)
    pq1 = train_pq(k1, instances, 4, 3, 5, 1)
    pq5 = train_pq(k1, instances, 4, 3, 5, 5)
    assert avg_euclidean_loss(instances, pq5) <= avg_euclidean_loss(instances, pq1) + 1e-6


def test_quantize_roundtrip_dtype_u16():
    # Code dtype is generic over integer widths (reference supports
    # u8/u16/u32/usize; primitives assert the fit at src/pq/primitives.rs:31-34).
    key = jax.random.PRNGKey(5)
    pq = Pq(codebooks=jax.random.uniform(key, (2, 300, 4), dtype=jnp.float32))
    x = jax.random.uniform(key, (7, 8), dtype=jnp.float32)
    codes = pq.quantize_batch(x, dtype=jnp.uint16)
    assert codes.dtype == jnp.uint16
    out = pq.reconstruct_batch(codes)
    assert out.shape == (7, 8)


def test_reconstruct_onehot_matches_gather():
    # The gather decode returns the codebook entries bit for bit (the
    # one-hot matmul it replaced had to run at precision="highest" to be
    # exact); checked against an explicit per-row numpy lookup.
    from reductive_tpu.pq import primitives

    key = jax.random.PRNGKey(9)
    kc, kq = jax.random.split(key)
    cb = jax.random.normal(kc, (5, 32, 6), dtype=jnp.float32)
    codes = jax.random.randint(kq, (100, 5), 0, 32, dtype=jnp.int32)
    got = np.asarray(primitives.reconstruct_batch(cb, codes.astype(jnp.uint8)))
    cb_np, codes_np = np.asarray(cb), np.asarray(codes)
    want = np.concatenate(
        [cb_np[j][codes_np[:, j]] for j in range(cb_np.shape[0])], axis=1
    )
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_quantize_batch_kernel_method(monkeypatch):
    # The model API resolves its kernel choice through dispatch.use_kernel:
    # the plain path by default on the CPU, the kernel when asked for.
    from reductive_tpu.ops import assign

    calls = []
    monkeypatch.setattr(assign, "pq_encode",
                        lambda cb, x, dtype: calls.append(x.shape) or
                        jnp.zeros((x.shape[0], cb.shape[0]), dtype))
    pq = make_test_pq()
    np.testing.assert_array_equal(
        pq.quantize_batch(ref_vectors(), dtype=jnp.int32), ref_quantizations())
    pq.quantize_batch(ref_vectors(), use_kernel=False)
    assert calls == []
    pq.quantize_batch(ref_vectors(), use_kernel=True)
    assert calls == [ref_vectors().shape]
    with pytest.raises(TypeError):
        pq.quantize_batch(ref_vectors(), method="kernel")


def test_trait_style_training_surface():
    """Reference-shaped marker-type API: Pq/Opq/GaussianOpq trainers with
    the reference's argument order, entropy-seeded or keyed."""
    from reductive_tpu.pq import GaussianOpq, Opq, PqTrainer

    x = jax.random.uniform(jax.random.PRNGKey(42), (256, 20), dtype=jnp.float32)

    def loss(pq):
        rec = pq.reconstruct_batch(pq.quantize_batch(x))
        return float(jnp.mean(jnp.sqrt(jnp.sum((x - rec) ** 2, axis=1))))

    key = jax.random.PRNGKey(42)
    assert loss(PqTrainer.train_pq_using(10, 7, 10, 1, x, key)) < 0.08
    assert loss(Opq.train_pq_using(10, 7, 10, 1, x, key)) < 0.10
    assert loss(GaussianOpq.train_pq_using(10, 7, 10, 1, x, key)) < 0.12
    # Entropy-seeded entry trains successfully (non-deterministic seed).
    assert loss(PqTrainer.train_pq(10, 7, 10, 1, x)) < 0.09


def test_quantize_reconstruct_into():
    """The *_into serving entries (buffer-donation analog of the
    reference's quantize_batch_into / reconstruct_batch_into,
    src/pq/primitives.rs:64,150): identical results to the plain paths,
    with shape validation on the donated output buffer."""
    import pytest

    from reductive_tpu.pq import quantize_batch_into, reconstruct_batch_into

    m, k, ds, n = 4, 16, 3, 64
    kc, kx = jax.random.split(jax.random.PRNGKey(0))
    pq = Pq(codebooks=jax.random.normal(kc, (m, k, ds), dtype=jnp.float32))
    x = jax.random.normal(kx, (n, m * ds), dtype=jnp.float32)

    expected_codes = pq.quantize_batch(x, dtype=jnp.uint8)
    out = jnp.zeros((n, m), jnp.uint8)
    codes = quantize_batch_into(pq, x, out)
    np.testing.assert_array_equal(np.asarray(codes), np.asarray(expected_codes))

    expected_rec = pq.reconstruct_batch(expected_codes)
    out_rec = jnp.zeros((n, m * ds), jnp.float32)
    rec = reconstruct_batch_into(pq, codes, out_rec)
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(expected_rec))

    with pytest.raises(ValueError, match="expected"):
        quantize_batch_into(pq, x, jnp.zeros((n, m + 1), jnp.uint8))
    with pytest.raises(ValueError, match="expected"):
        reconstruct_batch_into(pq, codes, jnp.zeros((n + 1, m * ds), jnp.float32))


def test_single_vector_into():
    """Single-vector caller-storage entries (reference Reconstruct::
    reconstruct_into, src/pq/traits.rs:133-141, and the single-vector
    quantize with caller output): equal to the plain single-vector
    paths, with shape validation."""
    import pytest

    from reductive_tpu.pq import quantize_vector_into, reconstruct_into

    m, k, ds = 4, 16, 3
    kc, kx = jax.random.split(jax.random.PRNGKey(3))
    pq = Pq(codebooks=jax.random.normal(kc, (m, k, ds), dtype=jnp.float32))
    x = jax.random.normal(kx, (m * ds,), dtype=jnp.float32)

    code = quantize_vector_into(pq, x, jnp.zeros((m,), jnp.uint8))
    np.testing.assert_array_equal(np.asarray(code),
                                  np.asarray(pq.quantize_vector(x)))
    rec = reconstruct_into(pq, code, jnp.zeros((m * ds,), jnp.float32))
    np.testing.assert_array_equal(np.asarray(rec),
                                  np.asarray(pq.reconstruct(code)))

    with pytest.raises(ValueError, match="expected"):
        quantize_vector_into(pq, x, jnp.zeros((m + 1,), jnp.uint8))
    with pytest.raises(ValueError, match="expected"):
        reconstruct_into(pq, code, jnp.zeros((m * ds + 1,), jnp.float32))


def test_quantize_batch_kernel_f32_method(interpret_kernels):
    """Pq.quantize_batch(use_kernel=True) routes through the encode kernel
    (here interpreted); on random data it matches the einsum oracle, and
    so does quantize_batch_into."""
    m, k, ds, n = 4, 16, 4, 200
    kc, kx = jax.random.split(jax.random.PRNGKey(9))
    pq = Pq(codebooks=jax.random.normal(kc, (m, k, ds), dtype=jnp.float32))
    x = jax.random.normal(kx, (n, m * ds), dtype=jnp.float32)

    codes = pq.quantize_batch(x, use_kernel=True)
    exact = pq.quantize_batch(x, use_kernel=False)
    np.testing.assert_array_equal(np.asarray(codes), np.asarray(exact))
    from reductive_tpu.pq import quantize_batch_into

    into = quantize_batch_into(pq, x, jnp.zeros((n, m), jnp.uint8), use_kernel=True)
    np.testing.assert_array_equal(np.asarray(into), np.asarray(exact))

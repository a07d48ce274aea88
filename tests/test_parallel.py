"""Sharded-execution tests on the virtual 8-device CPU mesh.

The stand-in for multi-host tests the reference never had (SURVEY.md §4):
every collective path (psum'd centroid statistics, model-axis sharding,
distributed encode) runs for real across 8 XLA devices, and results must
be numerically identical to the single-device programs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from reductive_tpu import Pq, train_pq
from reductive_tpu.kmeans import kmeans_iteration, kmeans_with_centroids, NIterations
from reductive_tpu.parallel import (
    encode_sharded,
    make_mesh,
    sharded_kmeans,
    sharded_pq_train_step,
    train_pq_sharded,
)


def test_make_mesh():
    mesh = make_mesh()
    assert mesh.devices.size == 8
    mesh2 = make_mesh((4, 2), ("data", "model"))
    assert mesh2.shape == {"data": 4, "model": 2}
    mesh3 = make_mesh((-1, 2), ("data", "model"))
    assert mesh3.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        make_mesh((3, 2), ("data", "model"))


def test_sharded_kmeans_matches_single_device():
    key = jax.random.PRNGKey(0)
    kx, kc = jax.random.split(key)
    x = jax.random.normal(kx, (256, 16), dtype=jnp.float32)
    centroids = jax.random.normal(kc, (8, 16), dtype=jnp.float32)

    ref_c, ref_loss = kmeans_with_centroids(x, centroids, NIterations(5))

    mesh = make_mesh()
    got_c, got_loss = sharded_kmeans(mesh, x, centroids, 5)
    np.testing.assert_allclose(np.asarray(got_c), np.asarray(ref_c), atol=1e-5)
    assert float(got_loss) == pytest.approx(float(ref_loss), rel=1e-5)


def test_sharded_pq_train_step_2d_mesh():
    # Full training step over a (data=4, model=2) mesh: subquantizers
    # sharded 2-way, instances 4-way; must match the single-device
    # per-subquantizer kmeans_iteration.
    key = jax.random.PRNGKey(1)
    kx, kc = jax.random.split(key)
    n, m, k, ds = 128, 4, 8, 4
    xs = jax.random.normal(kx, (n, m, ds), dtype=jnp.float32)
    codebooks = jax.random.normal(kc, (m, k, ds), dtype=jnp.float32)

    # Single-device reference: one Lloyd's iteration per subquantizer.
    ref_cbs, ref_losses = jax.vmap(kmeans_iteration)(
        jnp.moveaxis(xs, 1, 0), codebooks
    )
    # The reference loss normalizes per subquantizer by n*ds; the sharded
    # step returns a single global mse over all m*n*ds elements.
    ref_global = float(jnp.mean(ref_losses))

    mesh = make_mesh((4, 2), ("data", "model"))
    import functools

    run = jax.jit(
        functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P("data", "model", None), P("model", None, None)),
            out_specs=(P("model", None, None), P()),
        )(sharded_pq_train_step)
    )
    got_cbs, got_loss = run(xs, codebooks)
    np.testing.assert_allclose(np.asarray(got_cbs), np.asarray(ref_cbs), atol=1e-5)
    assert float(got_loss) == pytest.approx(ref_global, rel=1e-5)


def test_train_pq_sharded_quality():
    key = jax.random.PRNGKey(42)
    data_key, train_key = jax.random.split(key)
    instances = jax.random.uniform(data_key, (256, 20), dtype=jnp.float32)
    mesh = make_mesh()
    pq = train_pq_sharded(train_key, instances, 10, 7, 10, 1, mesh=mesh)
    codes = pq.quantize_batch(instances)
    rec = pq.reconstruct_batch(codes)
    loss = float(jnp.mean(jnp.sqrt(jnp.sum((instances - rec) ** 2, axis=1))))
    assert loss < 0.08

    # Same key, same data => identical codebooks as the unsharded trainer.
    pq_ref = train_pq(train_key, instances, 10, 7, 10, 1)
    np.testing.assert_allclose(
        np.asarray(pq.codebooks), np.asarray(pq_ref.codebooks), atol=1e-5
    )


def test_encode_sharded_matches_local(interpret_kernels):
    key = jax.random.PRNGKey(3)
    kx, kc = jax.random.split(key)
    x = jax.random.normal(kx, (256, 32), dtype=jnp.float32)
    pq = Pq(codebooks=jax.random.normal(kc, (4, 16, 8), dtype=jnp.float32))
    expected = pq.quantize_batch(x, dtype=jnp.uint8)

    mesh = make_mesh()
    got = encode_sharded(pq, x, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))

    got_kernel = encode_sharded(pq, x, mesh=mesh, use_kernel=True)
    np.testing.assert_array_equal(np.asarray(got_kernel), np.asarray(expected))


def test_train_pq_chunked_sharded_matches_single_device():
    """The corpus-scale sharded trainer (fused-stats building block + psum)
    reproduces the single-device chunked trainer bit-for-bit up to f32
    partial-sum ordering, and passes the reference quality gate."""
    from reductive_tpu.parallel import train_pq_chunked_sharded
    from reductive_tpu.pq.train import train_pq_chunked

    key = jax.random.PRNGKey(42)
    x = jax.random.uniform(key, (256, 20), dtype=jnp.float32)
    mesh = make_mesh()

    pq_sh = train_pq_chunked_sharded(
        key, x, 10, 7, 10, 2, mesh=mesh, chunk=16, use_kernel=False
    )
    pq_1d = train_pq_chunked(key, x, 10, 7, 10, 2, chunk=16, use_kernel=False)
    np.testing.assert_allclose(
        np.asarray(pq_sh.codebooks), np.asarray(pq_1d.codebooks), atol=1e-5
    )
    rec = pq_sh.reconstruct_batch(pq_sh.quantize_batch(x))
    loss = float(jnp.mean(jnp.sqrt(jnp.sum((x - rec) ** 2, axis=1))))
    assert loss < 0.08


def test_train_opq_chunked_sharded_quality():
    """Data-parallel chunked OPQ (psum'd stats + psum'd Procrustes
    cross-matrix) passes the reference Opq gate and stays close to the
    single-device trainer (exact equality is not expected: the SVD
    amplifies f32 psum-ordering differences across alternations)."""
    from reductive_tpu import train_opq_chunked
    from reductive_tpu.parallel import train_opq_chunked_sharded

    key = jax.random.PRNGKey(42)
    x = jax.random.uniform(key, (256, 20), dtype=jnp.float32)
    mesh = make_mesh()

    pq_sh = train_opq_chunked_sharded(
        key, x, 10, 7, 10, mesh=mesh, chunk=16, use_kernel=False
    )
    rec = pq_sh.reconstruct_batch(pq_sh.quantize_batch(x))
    loss = float(jnp.mean(jnp.sqrt(jnp.sum((x - rec) ** 2, axis=1))))
    assert loss < 0.1  # the reference Opq gate
    R = np.asarray(pq_sh.projection)
    np.testing.assert_allclose(R.T @ R, np.eye(20), atol=1e-4)

    pq_1d = train_opq_chunked(key, x, 10, 7, 10, chunk=16, use_kernel=False)
    rec1 = pq_1d.reconstruct_batch(pq_1d.quantize_batch(x))
    loss1 = float(jnp.mean(jnp.sqrt(jnp.sum((x - rec1) ** 2, axis=1))))
    assert abs(loss - loss1) < 5e-3


def test_sharded_gaussian_opq_composition():
    """Sharded GaussianOpq = closed-form projection + the sharded PQ
    trainer with on-the-fly rotation; matches the single-device
    train_gaussian_opq_chunked to one ulp."""
    from reductive_tpu import train_gaussian_opq_chunked
    from reductive_tpu.parallel import train_pq_chunked_sharded
    from reductive_tpu.pq.opq import create_projection_matrix

    key = jax.random.PRNGKey(42)
    x = jax.random.uniform(key, (256, 20), dtype=jnp.float32)
    mesh = make_mesh()

    R = create_projection_matrix(x, 10)
    pq_sh = train_pq_chunked_sharded(
        key, x, 10, 7, 10, 1, mesh=mesh, chunk=16, use_kernel=False,
        projection=R,
    )
    pq_1d = train_gaussian_opq_chunked(key, x, 10, 7, 10, 1, chunk=16, use_kernel=False)
    np.testing.assert_allclose(
        np.asarray(pq_sh.codebooks), np.asarray(pq_1d.codebooks), atol=1e-5
    )
    rec = pq_sh.reconstruct_batch(pq_sh.quantize_batch(x))
    loss = float(jnp.mean(jnp.sqrt(jnp.sum((x - rec) ** 2, axis=1))))
    assert loss < 0.12


def test_initialize_distributed_raises_on_multihost_signal(monkeypatch):
    """A failed auto-discovery must NOT silently fall back to
    single-process when the environment names a coordinator (every
    process would otherwise train on its own shard alone)."""
    import pytest

    from reductive_tpu.parallel import launch

    monkeypatch.setattr(launch, "_initialized", False)
    for name in launch._MULTIHOST_ENV_SIGNALS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "host0:1234")

    def boom(**kwargs):
        raise RuntimeError("no coordinator")

    monkeypatch.setattr(launch.jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="multi-host membership"):
        launch.initialize_distributed()

    # Without any multi-host signal the fallback stays silent (warning only).
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    monkeypatch.setattr(launch, "_initialized", False)
    launch.initialize_distributed()  # no raise


def test_chip_smoke_four_device_phase():
    """The four-card phase of chip_smoke.py (sharded training, encode,
    exhaustive and IVF search, each against its single-device form) on
    four of the virtual CPU devices, at the rehearsal sizes."""
    import importlib.util
    import os
    import sys

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", smoke)
    spec.loader.exec_module(smoke)
    sm = smoke.Smoke(smoke.REHEARSAL, seed=0, card="cpu")
    smoke.phase_four(sm, jax.devices()[:4])

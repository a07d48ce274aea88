"""Smoke tests for the profiling/timing helpers."""

import jax
import jax.numpy as jnp

from reductive_tpu.utils.profiling import benchmark, trace


def test_device_sync_pytree():
    """benchmark() waits on every leaf of a mixed-pytree result."""
    tree = {"a": jnp.ones((4, 4)), "b": (jnp.zeros(3), None), "c": 7}
    assert benchmark(lambda t: t, tree, iters=1) >= 0


def test_enable_compile_cache_prefers_env(monkeypatch, tmp_path):
    """The helper leaves a set JAX_COMPILATION_CACHE_DIR alone and
    otherwise points JAX at the repository's fixed cache path."""
    from reductive_tpu.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    try:
        path = cache.enable_compile_cache()
        assert path.endswith(".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_benchmark_returns_positive_time():
    f = jax.jit(lambda x: x @ x.T)
    x = jnp.ones((64, 64))
    dt = benchmark(f, x, iters=2)
    assert dt > 0


def test_trace_writes_profile(tmp_path):
    with trace(str(tmp_path)):
        jnp.sum(jnp.ones((8, 8))).block_until_ready()
    # A plugins/profile/<ts> directory with at least one file appears.
    produced = list(tmp_path.rglob("*"))
    assert any(p.is_file() for p in produced)

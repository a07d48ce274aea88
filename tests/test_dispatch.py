"""The kernel-or-plain choice (reductive_tpu.dispatch): one function looks
at the platform, honours an explicit request, refuses a kernel for a
shape it does not cover, and logs what it chose."""

import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import reductive_tpu.dispatch as dispatch
from reductive_tpu import Pq
from reductive_tpu.search import search


def test_gpu_picks_kernel(monkeypatch):
    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: "gpu")
    assert dispatch.use_kernel("encode")
    assert dispatch.use_kernel("adc", codes_dtype=jnp.uint8, packed=False)
    assert dispatch.use_kernel("adc", codes_dtype=jnp.uint8, packed=True)


def test_cpu_picks_plain():
    assert jax.default_backend() == "cpu"
    assert not dispatch.use_kernel("encode")
    assert not dispatch.use_kernel("adc", codes_dtype=jnp.uint8, packed=False)


def test_uncovered_shape_stays_plain_on_gpu(monkeypatch):
    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: "gpu")
    assert not dispatch.use_kernel("adc", codes_dtype=jnp.uint16, packed=False)


@pytest.mark.parametrize("requested", [True, False])
def test_explicit_request_is_honoured(monkeypatch, requested):
    for backend in ("cpu", "gpu"):
        monkeypatch.setattr(dispatch.jax, "default_backend", lambda: backend)
        assert dispatch.use_kernel("encode", requested) is requested
        assert dispatch.use_kernel("adc", requested, codes_dtype=jnp.uint8,
                                   packed=False) is requested


def test_no_silent_fallback():
    """Asking for a kernel it cannot run raises, at the dispatch and at
    the entry points, instead of quietly running the plain path."""
    with pytest.raises(ValueError, match="does not cover"):
        dispatch.use_kernel("adc", True, codes_dtype=jnp.uint16, packed=False)
    with pytest.raises(ValueError, match="unknown kernel op"):
        dispatch.use_kernel("decode")
    pq = Pq(codebooks=jnp.ones((2, 300, 2), jnp.float32))
    codes16 = jnp.zeros((8, 2), jnp.uint16)
    with pytest.raises(ValueError, match="uint8"):
        search(pq, jnp.ones((1, 4)), codes16, top_k=1, method="kernel")


def test_choice_is_logged(caplog, monkeypatch):
    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: "gpu")
    with caplog.at_level(logging.DEBUG, logger="reductive_tpu"):
        dispatch.use_kernel("encode")
        dispatch.use_kernel("adc", False, codes_dtype=jnp.uint8, packed=False)
    text = caplog.text
    assert "encode" in text and "kernel path" in text
    assert "plain path (requested)" in text


def test_encode_routes_by_flag(interpret_kernels, monkeypatch):
    """dispatch.encode runs the kernel only when told to, and both paths
    give the same codes."""
    import reductive_tpu.ops.assign as assign

    calls = []
    real = assign.pq_encode
    monkeypatch.setattr(assign, "pq_encode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kc, kx = jax.random.split(jax.random.PRNGKey(3))
    cb = jax.random.normal(kc, (4, 16, 8), jnp.float32)
    x = jax.random.normal(kx, (50, 32), jnp.float32)
    plain = dispatch.encode(cb, x, use_kernel=False)
    assert not calls
    kern = dispatch.encode(cb, x, use_kernel=True)
    assert calls
    np.testing.assert_array_equal(np.asarray(kern), np.asarray(plain))

"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Multi-card hardware is not available where the suite runs; instead the
suite runs on the CPU platform with 8 virtual XLA devices so every
sharding / collective code path (``Mesh`` + ``shard_map`` + ``psum``)
executes for real — the stand-in for the multi-host tests the reference
never had (see SURVEY.md §4).  Must be set before JAX initializes.

Tests marked ``gpu`` take the :func:`gpu` fixture and skip unless JAX's
default backend is an NVIDIA GPU; run them on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import functools
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

# Golden fixtures from the reference use f64 in the k-means tests
# (reference: src/kmeans.rs:437); enable x64 so both f32 and f64 paths
# are exercised.  Explicit dtypes are used everywhere in the library.
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless the default backend is a GPU (decided per test, never
    at import time, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda pytest -m gpu")


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Route the library's kernel calls through the Pallas interpreter,
    so a test can drive a ``use_kernel=True`` entry
    point on the CPU."""
    from reductive_tpu.ops import adc, assign

    monkeypatch.setattr(
        assign, "pq_encode", functools.partial(assign.pq_encode, interpret=True)
    )
    monkeypatch.setattr(
        adc, "adc_scores_kernel",
        functools.partial(adc.adc_scores_kernel, interpret=True),
    )

"""Profiling and timing helpers.

The reference's only performance tooling is its criterion harness
(``benches/pq.rs``, ``benches/linalg.rs``); the JAX equivalents are
``jax.profiler`` traces (viewable in XProf/TensorBoard) plus a wall-clock
helper that waits for the device with ``jax.block_until_ready`` (JAX
dispatch is asynchronous, so a timing without it measures the enqueue).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax

__all__ = ["trace", "benchmark"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``jax.profiler`` trace of the enclosed block.

    View with ``tensorboard --logdir <log_dir>`` (or XProf).  Usage::

        with trace("/tmp/jax-trace"):
            pq = train_pq(key, x, 16, 8, 25)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def benchmark(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Median-free simple benchmark: mean seconds per call of ``fn(*args)``
    after ``warmup`` compile/warm calls, each timed window ending in
    ``jax.block_until_ready`` on the (pytree) result."""
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters

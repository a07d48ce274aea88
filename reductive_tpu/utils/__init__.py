"""Utilities: profiling, timing, and benchmark helpers."""

from .cache import enable_compile_cache
from .profiling import benchmark, trace

__all__ = ["trace", "benchmark", "enable_compile_cache"]

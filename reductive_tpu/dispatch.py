"""The one place the library chooses between a GPU kernel and plain XLA.

Two operations have hand-written kernels (Pallas through Triton, see
:mod:`reductive_tpu.ops`): ``"encode"`` (nearest-centroid assignment, the
encode hot path and the assign half of every Lloyd's step) and ``"adc"``
(lookup-table scoring of uint8 or packed-u4 codes, the search hot path).
Everything else is plain JAX that XLA compiles for whatever device it
finds.

:func:`use_kernel` is the only function that looks at the platform.  Every
entry point that has a kernel path takes ``use_kernel=None`` and resolves
it here: ``None`` picks the kernel on a GPU when the shape is one the
kernel covers, and the plain path otherwise; ``True``/``False`` are
honoured as given, and ``True`` on a shape the kernel does not cover is an
error, never a silent fallback.  The choice is logged at DEBUG level on
the ``reductive_tpu`` logger.
"""

from __future__ import annotations

import logging
from typing import Optional

import jax
import jax.numpy as jnp
from jax import Array

logger = logging.getLogger("reductive_tpu")

__all__ = ["use_kernel", "encode"]


def _covers(op: str, **shape) -> bool:
    """Whether ``op``'s kernel handles ``shape``.

    The ``"encode"`` kernel covers every codebook shape; ``"adc"`` takes
    ``codes_dtype`` and ``packed`` and covers uint8 or packed-u4 codes.
    """
    if op == "encode":
        return True
    if op == "adc":
        return bool(shape.get("packed")) or (
            jnp.dtype(shape["codes_dtype"]) == jnp.uint8
        )
    raise ValueError(f"unknown kernel op {op!r}")


def use_kernel(op: str, requested: Optional[bool] = None, **shape) -> bool:
    """Resolve a ``use_kernel`` argument for ``op`` at ``shape``.

    Returns True when the GPU kernel should run: on a ``gpu`` platform
    for a covered shape when ``requested`` is None, or when the caller
    asked for it.  Raises ``ValueError`` when the caller asked for the
    kernel on a shape it does not cover.
    """
    covered = _covers(op, **shape)
    if requested is None:
        platform = jax.default_backend()
        choice = platform == "gpu" and covered
        reason = f"platform={platform}, covered={covered}"
    else:
        if requested and not covered:
            raise ValueError(f"the {op} kernel does not cover {shape}")
        choice = bool(requested)
        reason = "requested"
    logger.debug("%s %s: %s path (%s)", op, shape,
                 "kernel" if choice else "plain", reason)
    return choice


def encode(codebooks: Array, x: Array, *, dtype=jnp.uint8,
           use_kernel: bool) -> Array:
    """``(n, m)`` codes of ``x`` against ``(m, k, ds)`` codebooks: the
    Triton kernel (:func:`reductive_tpu.ops.assign.pq_encode`) or the f32
    einsum (:func:`reductive_tpu.pq.primitives.quantize_batch`)."""
    if use_kernel:
        from .ops import assign

        return assign.pq_encode(codebooks, x, dtype=dtype)
    from .pq import primitives

    return primitives.quantize_batch(codebooks, x, dtype=dtype)

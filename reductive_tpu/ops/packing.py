"""Device-side 4-bit code packing.

4-bit codes (``k <= 16`` — the reference's own benchmark configuration,
``/root/reference/benches/pq.rs:9-10`` uses 4-bit subquantizers) halve
the code matrix: at 100M x m=24 that is 1.2 GB instead of 2.4 GB of
device memory, doubling the corpus a card can serve.  The byte layout matches the
host-side :func:`reductive_tpu.native.pack_u4` (even-index code in the
low nibble, odd-index in the high nibble), so device-packed codes can be
written straight to the native artifact format and vice versa.

These are plain XLA ops (cheap elementwise + reshape); the ADC kernel
consumes the *packed* matrix directly and splits the nibbles in
registers (:func:`reductive_tpu.ops.adc.adc_scores_kernel` with
``packed=True``), halving the code bytes a scoring sweep reads.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

__all__ = ["pack_u4_codes", "unpack_u4_codes"]


def pack_u4_codes(codes: Array) -> Array:
    """Pack an ``(n, m)`` code matrix (values < 16, ``m`` even) into
    ``(n, m/2)`` bytes: code ``2j`` in the low nibble, ``2j+1`` in the
    high nibble of byte ``j`` (the native ``pack_u4`` layout)."""
    n, m = codes.shape
    if m % 2 != 0:
        raise ValueError(f"packed u4 codes require even m, got {m}")
    c = codes.astype(jnp.uint8)
    return c[:, 0::2] | (c[:, 1::2] << 4)


def unpack_u4_codes(packed: Array) -> Array:
    """Inverse of :func:`pack_u4_codes`: ``(n, m/2)`` bytes back to the
    ``(n, m)`` code matrix."""
    p = packed.astype(jnp.uint8)
    lo = p & 0xF
    hi = p >> 4
    return jnp.stack([lo, hi], axis=2).reshape(p.shape[0], -1)

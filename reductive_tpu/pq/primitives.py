"""Quantization primitives: encode and reconstruct against a codebook tensor.

Counterpart of the reference's ``pub(crate)`` primitives
(reference: ``src/pq/primitives.rs``).  The reference loops sequentially
over the ``m`` subquantizers, doing one ``(n, ds) x (ds, k)`` GEMM plus a
scalar argmin per subquantizer (``src/pq/primitives.rs:90-103``), and
reconstructs row-at-a-time with scalar gathers
(``src/pq/primitives.rs:141-147``).  Here both directions are single
batched tensor programs over the ``m`` axis:

* **encode** — reshape ``(n, d) → (n, m, ds)``, one batched einsum
  ``nmd,mkd->nmk`` for the cross terms, norm-expansion distances, argmin
  over ``k``.  This is the plain version; the GPU kernel that never
  writes the ``(n, m, k)`` distance tensor lives in
  ``reductive_tpu.ops.assign``.
* **decode** — one vectorized gather ``codebooks[j, codes[:, j]]`` over all
  rows at once, reshaped back to ``(n, d)``.

Codebooks use the same layout as the reference's ``quantizers`` field:
``(m, k, ds)`` = (subquantizers, centroids-per-subquantizer, subvector dim)
(``src/pq/pq.rs:29-32``).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import Array

__all__ = [
    "reconstructed_len",
    "check_code_dtype",
    "quantize_batch",
    "quantize",
    "reconstruct_batch",
    "reconstruct",
]


def reconstructed_len(codebooks: Array) -> int:
    """Length of a reconstructed vector: ``m * ds`` (reference:
    ``src/pq/primitives.rs:106-108``)."""
    return codebooks.shape[0] * codebooks.shape[2]


def check_code_dtype(codebooks: Array, dtype) -> None:
    """Reject code dtypes too narrow to hold ``k - 1``.

    Mirrors the runtime assert in the reference
    (``src/pq/primitives.rs:31-34``): storing centroids ``0..k-1`` in an
    integer type requires ``k - 1 <= max(dtype)``.  Checked on the host
    since ``k`` is static.
    """
    dtype = np.dtype(dtype)
    if not np.issubdtype(dtype, np.integer):
        raise TypeError(f"Quantized code dtype must be an integer type, got {dtype}")
    k = codebooks.shape[1]
    if k - 1 > np.iinfo(dtype).max:
        raise OverflowError(
            f"Cannot store centroids in quantizer index type: k={k} exceeds {dtype}"
        )


def quantize_batch(codebooks: Array, x: Array, dtype=jnp.uint8, *, precision="highest") -> Array:
    """Encode a batch of vectors to per-subquantizer centroid indices.

    ``codebooks`` is ``(m, k, ds)``, ``x`` is ``(n, m * ds)``; returns
    ``(n, m)`` codes of ``dtype``.  Argmin ties break to the first index,
    matching the reference's assignment loop
    (``src/pq/primitives.rs:90-103`` → ``src/kmeans.rs:149-156``).
    """
    check_code_dtype(codebooks, dtype)
    m, k, ds = codebooks.shape
    if x.ndim != 2 or x.shape[1] != m * ds:
        raise ValueError(
            f"Quantizer and vector length mismatch: input has {x.shape[-1]} columns, "
            f"quantizer reconstructs {m * ds}"
        )
    xs = x.reshape(x.shape[0], m, ds)
    # |x|^2 is constant per (row, subquantizer) and does not affect the
    # argmin over k, so only the centroid norms and cross terms are needed.
    c_sqn = jnp.einsum("mkd,mkd->mk", codebooks, codebooks, precision=precision)
    cross = jnp.einsum("nmd,mkd->nmk", xs, codebooks, precision=precision)
    dists = c_sqn[None, :, :] - (cross + cross)
    return jnp.argmin(dists, axis=2).astype(dtype)


def quantize(codebooks: Array, x: Array, dtype=jnp.uint8, *, precision="highest") -> Array:
    """Encode a single vector (reference: ``src/pq/primitives.rs:14-49``)."""
    if x.ndim != 1:
        raise ValueError(f"quantize expects a rank-1 vector, got rank {x.ndim}")
    return quantize_batch(codebooks, x[None, :], dtype=dtype, precision=precision)[0]


def reconstruct_batch(codebooks: Array, codes: Array) -> Array:
    """Decode a batch of code rows back to approximate vectors.

    ``codes`` is ``(n, m)``; returns ``(n, m * ds)``.  Replaces the
    reference's per-row chunk-assign loop
    (``src/pq/primitives.rs:150-173``) with one vectorized row gather
    ``codebooks[j, codes[:, j]]``: memory-bound, and bit-exact (each
    output element is a copy of a codebook entry).
    """
    m, k, ds = codebooks.shape
    if codes.ndim != 2 or codes.shape[1] != m:
        raise ValueError(
            f"Quantization length does not match number of subquantizers: "
            f"{codes.shape} vs m={m}"
        )
    idx = codes.astype(jnp.int32)
    gathered = jnp.take_along_axis(codebooks[None, :, :, :],
                                   idx[:, :, None, None], axis=2)[:, :, 0, :]
    return gathered.reshape(codes.shape[0], m * ds)


def reconstruct(codebooks: Array, code: Array) -> Array:
    """Decode a single code row (reference: ``src/pq/primitives.rs:110-148``)."""
    if code.ndim != 1:
        raise ValueError(f"reconstruct expects a rank-1 code vector, got rank {code.ndim}")
    return reconstruct_batch(codebooks, code[None, :])[0]

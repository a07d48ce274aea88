"""The product-quantizer model: a JAX pytree holding codebooks + projection.

Counterpart of the reference's ``Pq<A>`` struct (reference:
``src/pq/pq.rs:29-61``): the model state is exactly an optional ``(d, d)``
projection and an ``(m, k, ds)`` codebook tensor.  Registered as a pytree
so a ``Pq`` can flow through ``jit``/``vmap``/``shard_map`` and be donated,
sharded, or checkpointed like any other parameter structure.

Apply paths (reference: ``src/pq/pq.rs:252-348``):

* ``quantize_batch`` — optionally project by ``R``, then the batched
  encode primitive.
* ``reconstruct_batch`` — the batched gather, then optionally the inverse
  projection by ``R^T`` (valid because the learned projections are
  orthonormal).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import Array

from . import primitives

__all__ = [
    "Pq", "quantize_batch_into", "reconstruct_batch_into",
    "quantize_vector_into", "reconstruct_into",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Pq:
    """Product quantizer (Jégou et al., 2011): ``m`` subquantizers of ``k``
    centroids each over ``ds``-dimensional subvectors, with an optional
    learned orthonormal projection applied before slicing.

    ``codebooks`` has shape ``(m, k, ds)`` — the same layout as the
    reference's ``quantizers`` field (``src/pq/pq.rs:31``).
    """

    codebooks: Array
    projection: Optional[Array] = None

    def __post_init__(self) -> None:
        if hasattr(self.codebooks, "ndim"):
            if self.codebooks.ndim != 3:
                raise ValueError(
                    f"codebooks must have shape (m, k, ds), got {self.codebooks.shape}"
                )
            if self.codebooks.size == 0:
                raise ValueError(
                    "Attempted to construct a product quantizer without quantizers."
                )
            d = primitives.reconstructed_len(self.codebooks)
            if self.projection is not None and hasattr(self.projection, "shape"):
                if tuple(self.projection.shape) != (d, d):
                    raise ValueError(
                        f"Incorrect projection matrix shape, was: {self.projection.shape}, "
                        f"should be [{d}, {d}]"
                    )

    # -- shape accessors (reference: src/pq/pq.rs:103-110,191-193,300-302,345-347)

    @property
    def n_subquantizers(self) -> int:
        return self.codebooks.shape[0]

    @property
    def n_quantizer_centroids(self) -> int:
        """Number of centroids per subquantizer (``k``)."""
        return self.codebooks.shape[1]

    @property
    def quantized_len(self) -> int:
        """Length of a quantized vector: one code per subquantizer."""
        return self.codebooks.shape[0]

    @property
    def reconstructed_len(self) -> int:
        """Length of a reconstructed vector (``m * ds``)."""
        return primitives.reconstructed_len(self.codebooks)

    @property
    def subquantizers(self) -> Array:
        """The ``(m, k, ds)`` codebook tensor."""
        return self.codebooks

    # -- encode (reference: src/pq/pq.rs:252-303)

    def quantize_batch(
        self, x: Array, dtype=jnp.uint8, *, precision="highest",
        use_kernel: Optional[bool] = None,
    ) -> Array:
        """Encode ``(n, d)`` vectors to ``(n, m)`` codes of ``dtype``.

        ``use_kernel`` is resolved by :func:`reductive_tpu.dispatch.use_kernel`:
        on a GPU the fused encode kernel
        (:func:`reductive_tpu.ops.assign.pq_encode`) runs, which agrees
        with the f32 einsum except on centroids equidistant to within f32
        rounding; elsewhere the einsum at ``precision``.
        """
        from .. import dispatch

        if self.projection is not None:
            x = jnp.dot(x, self.projection, precision=precision)
        if dispatch.use_kernel("encode", use_kernel):
            return dispatch.encode(self.codebooks, x, dtype=dtype, use_kernel=True)
        return primitives.quantize_batch(self.codebooks, x, dtype=dtype, precision=precision)

    def quantize_vector(self, x: Array, dtype=jnp.uint8, *, precision="highest") -> Array:
        """Encode a single ``(d,)`` vector to ``(m,)`` codes."""
        if self.projection is not None:
            x = jnp.dot(x, self.projection, precision=precision)
        return primitives.quantize(self.codebooks, x, dtype=dtype, precision=precision)

    # -- decode (reference: src/pq/pq.rs:305-348)

    def reconstruct_batch(self, codes: Array, *, precision="highest") -> Array:
        """Decode ``(n, m)`` codes to approximate ``(n, d)`` vectors (the
        bit-exact row gather of
        :func:`reductive_tpu.pq.primitives.reconstruct_batch`)."""
        out = primitives.reconstruct_batch(self.codebooks, codes)
        if self.projection is not None:
            out = jnp.dot(out, self.projection.T, precision=precision)
        return out

    def reconstruct(self, code: Array, *, precision="highest") -> Array:
        """Decode a single ``(m,)`` code row to a ``(d,)`` vector."""
        out = primitives.reconstruct(self.codebooks, code)
        if self.projection is not None:
            out = jnp.dot(out, self.projection.T, precision=precision)
        return out


# ---------------------------------------------------------------------------
# Preallocated-output serving entries (reference: quantize_batch_into /
# reconstruct_batch_into, src/pq/primitives.rs:64,150 + traits.rs:109-141).
#
# The reference's *_into methods exist so a serving loop can reuse one
# output buffer instead of allocating per call.  The JAX-idiomatic
# equivalent is **buffer donation**: the caller's ``out`` array is donated
# to the jitted program, XLA aliases the result into its memory, and the
# steady-state HBM high-water of a serving loop stays at one output buffer
# (donation is a no-op on backends that do not support it, e.g. CPU).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, donate_argnums=(2,), static_argnames=("use_kernel", "dtype"))
def _quantize_into(pq: Pq, x: Array, out: Array, use_kernel, dtype) -> Array:
    del out  # donated: XLA aliases its buffer to the returned codes
    return pq.quantize_batch(x, dtype=dtype, use_kernel=use_kernel)


def quantize_batch_into(pq: Pq, x: Array, out: Array, *,
                        use_kernel: Optional[bool] = None) -> Array:
    """Encode ``(n, d)`` vectors, reusing ``out``'s device memory.

    ``out`` must be an ``(n, m)`` device array of the desired code dtype;
    it is **donated** (its buffer is consumed — do not reuse the array
    object afterwards) and the returned codes alias it where the backend
    supports donation.  The analog of the reference's
    ``quantize_batch_into`` (``src/pq/primitives.rs:64-104``).
    ``use_kernel`` is as for :meth:`Pq.quantize_batch`.
    """
    n, m = x.shape[0], pq.quantized_len
    if tuple(out.shape) != (n, m):
        raise ValueError(f"out has shape {out.shape}, expected {(n, m)}")
    return _quantize_into(pq, x, out, use_kernel, jnp.dtype(out.dtype))


@functools.partial(jax.jit, donate_argnums=(2,))
def _reconstruct_into(pq: Pq, codes: Array, out: Array) -> Array:
    del out
    return pq.reconstruct_batch(codes)


def reconstruct_batch_into(pq: Pq, codes: Array, out: Array) -> Array:
    """Decode ``(n, m)`` codes, reusing ``out``'s device memory.

    ``out`` must be an ``(n, d)`` f32 device array; it is **donated** and
    the returned reconstruction aliases it where the backend supports
    donation.  The analog of the reference's ``reconstruct_batch_into``
    (``src/pq/primitives.rs:150-173``, ``traits.rs:109-117``).
    """
    n, d = codes.shape[0], pq.reconstructed_len
    if tuple(out.shape) != (n, d):
        raise ValueError(f"out has shape {out.shape}, expected {(n, d)}")
    return _reconstruct_into(pq, codes, out)


def quantize_vector_into(pq: Pq, x: Array, out: Array) -> Array:
    """Encode ONE ``(d,)`` vector, reusing ``out``'s device memory.

    ``out`` must be a ``(m,)`` device array of the desired code dtype; it
    is **donated** and the returned code row aliases it where the backend
    supports donation.  The single-vector counterpart of
    :func:`quantize_batch_into` — mirrors the reference's
    ``QuantizeVector::quantize_vector_into``-style caller-storage entry
    (``src/pq/traits.rs:56-76``; single code row, caller-owned output).
    """
    m = pq.quantized_len
    if tuple(out.shape) != (m,):
        raise ValueError(f"out has shape {out.shape}, expected {(m,)}")
    return _quantize_vec_into(pq, x, out, jnp.dtype(out.dtype))


def reconstruct_into(pq: Pq, code: Array, out: Array) -> Array:
    """Decode ONE ``(m,)`` code row, reusing ``out``'s device memory.

    ``out`` must be a ``(d,)`` f32 device array; it is **donated** and the
    returned vector aliases it where the backend supports donation.  The
    single-vector counterpart of :func:`reconstruct_batch_into` — the
    analog of the reference's ``Reconstruct::reconstruct_into``
    (``src/pq/traits.rs:133-141``).
    """
    d = pq.reconstructed_len
    if tuple(out.shape) != (d,):
        raise ValueError(f"out has shape {out.shape}, expected {(d,)}")
    return _reconstruct_vec_into(pq, code, out)


@functools.partial(jax.jit, donate_argnums=(2,), static_argnames=("dtype",))
def _quantize_vec_into(pq: Pq, x: Array, out: Array, dtype) -> Array:
    del out  # donated: XLA aliases its buffer to the returned code row
    return pq.quantize_vector(x, dtype=dtype)


@functools.partial(jax.jit, donate_argnums=(2,))
def _reconstruct_vec_into(pq: Pq, code: Array, out: Array) -> Array:
    del out
    return pq.reconstruct_batch(code[None, :])[0]

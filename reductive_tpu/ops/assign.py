"""Fused PQ-encode / nearest-centroid kernel (Pallas through Triton).

The encode hot path (reference call stack: ``src/pq/pq.rs:256`` →
``src/pq/primitives.rs:64-104`` → ``src/kmeans.rs:133-159``) computes, for
every input row and every subquantizer, squared distances to all ``k``
centroids and takes the argmin.  The plain XLA version
(:func:`reductive_tpu.pq.primitives.quantize_batch`) writes the whole
``(n, m, k)`` f32 distance tensor to device memory before the argmin:
16 KB per 128-d row against 512 B of input.  This kernel reads only the
input and writes only the codes.

Layout, one program per tile of ``block_n`` rows:

* the distance cross terms of subquantizer ``j`` are tensor-core dots
  ``x[:, j*ds + c*depth : ...] @ W[j, c]`` over ``ceil(ds / depth)``
  slabs of ``depth >= 16`` columns (16 is the least depth a Triton dot
  takes).  ``W`` is zero past row ``ds``, so a slab that runs into the
  next subquantizer's columns adds nothing; for ``ds < 16`` the dot does
  ``16 / ds`` times the useful work instead of padding ``x``;
* centroids are visited in tiles of ``k_tile`` columns with a running
  (minimum, index) pair, so the ``(block_n, k)`` distances never leave
  registers and ``k`` may be as large as a coarse quantizer's;
* the argmin breaks ties to the first index, as the reference does
  (``src/kmeans.rs:149-156``).

The dots run in TF32 with three passes (``TF32_TF32_F32_X3``, about 21
bits of each product), so codes agree with the f32 einsum except where
two centroids are equidistant to within f32 rounding.  Padded centroids
carry a ``+inf`` norm and never win.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import Array, lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["pq_encode", "assign_nearest"]


def _next_pow2(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def _layout(codebooks: Array, k_pad: int):
    """Pack ``(m, k, ds)`` codebooks into the kernel's ``(m, n_depth,
    depth, k_pad)`` dot operands (zero past row ``ds`` and column ``k``)
    and ``(m, k_pad)`` centroid norms (``+inf`` past ``k``)."""
    m, k, ds = codebooks.shape
    depth = next((c for c in (64, 32) if ds % c == 0), 16)
    n_depth = -(-ds // depth)
    cb = codebooks.astype(jnp.float32)
    w = jnp.pad(cb, ((0, 0), (0, k_pad - k), (0, n_depth * depth - ds)))
    w = w.reshape(m, k_pad, n_depth, depth).transpose(0, 2, 3, 1)
    sqn = jnp.einsum("mkd,mkd->mk", cb, cb, precision="highest")
    sqn = jnp.pad(sqn, ((0, 0), (0, k_pad - k)), constant_values=jnp.inf)
    return w, sqn, depth


def _encode_kernel(x_ref, w_ref, sqn_ref, codes_ref, *, n, d, ds, block_n,
                   depth, n_depth, k_tile, n_tiles, precision):
    i = pl.program_id(0)
    rows = pl.ds(i * block_n, block_n)
    valid = i * block_n + jnp.arange(block_n, dtype=jnp.int32) < n

    def subquantizer(j, carry):
        def slab(c):
            start = j * ds + c * depth
            in_x = start + jnp.arange(depth, dtype=jnp.int32) < d
            return plgpu.load(
                x_ref.at[rows, pl.ds(start, depth)],
                mask=valid[:, None] & in_x[None, :], other=0.0,
            )

        # One slab stays in registers across the centroid tiles.  Deeper
        # subvectors (ds > 64, e.g. a 768-d coarse quantizer) loop over
        # their depth chunks, reloading each from L1/L2 per tile: unrolled,
        # their operands would not fit in shared memory together.
        first = slab(0) if n_depth == 1 else None

        def tile(t, best_arg):
            best, arg = best_arg
            cols = pl.ds(t * k_tile, k_tile)
            if n_depth == 1:
                s = pl.dot(first, w_ref[j, 0, :, cols], precision=precision)
            else:
                s = lax.fori_loop(
                    jnp.int32(0), jnp.int32(n_depth),
                    lambda c, acc: acc + pl.dot(
                        slab(c), w_ref[j, c, :, cols], precision=precision),
                    jnp.zeros((block_n, k_tile), jnp.float32),
                )
            dist = sqn_ref[j, cols][None, :] - 2.0 * s
            tmin = jnp.min(dist, axis=1)
            targ = lax.argmin(dist, 1, jnp.int32) + t * k_tile
            better = tmin < best  # strict: ties keep the earlier tile
            return jnp.where(better, tmin, best), jnp.where(better, targ, arg)

        init = (jnp.full((block_n,), jnp.inf, jnp.float32),
                jnp.zeros((block_n,), jnp.int32))
        _, arg = lax.fori_loop(jnp.int32(0), jnp.int32(n_tiles), tile, init)
        plgpu.store(codes_ref.at[rows, j], arg.astype(codes_ref.dtype),
                    mask=valid)
        return carry

    # int32 bounds keep the loop index the type of program_id's offsets
    # (under jax_enable_x64 Python ints would make it int64).
    lax.fori_loop(jnp.int32(0), jnp.int32(codes_ref.shape[1]), subquantizer, 0)


@functools.partial(
    jax.jit, static_argnames=("dtype", "block_n", "k_tile", "interpret")
)
def pq_encode(
    codebooks: Array,
    x: Array,
    *,
    dtype=jnp.uint8,
    block_n: int = 128,
    k_tile: int = 64,
    interpret: bool = False,
) -> Array:
    """Encode ``(n, d)`` vectors to ``(n, m)`` codes with the fused kernel.

    Same contract as :func:`reductive_tpu.pq.primitives.quantize_batch`
    (first-index tie-break; f32 distances, here from three-pass TF32
    dots).  ``block_n`` rows per program and ``k_tile`` centroids per
    step are tuning knobs; ``interpret=True`` runs the
    Pallas interpreter (CPU tests), where dots are plain f32.
    """
    from ..pq.primitives import check_code_dtype

    check_code_dtype(codebooks, dtype)
    m, k, ds = codebooks.shape
    n, d = x.shape
    if d != m * ds:
        raise ValueError(
            f"Quantizer and vector length mismatch: input has {d} columns, "
            f"quantizer reconstructs {m * ds}"
        )
    k_pad = max(16, _next_pow2(k))
    k_tile = min(k_tile, k_pad)
    w, sqn, depth = _layout(codebooks, k_pad)
    precision = (lax.Precision.HIGHEST if interpret
                 else lax.DotAlgorithmPreset.TF32_TF32_F32_X3)
    kernel = functools.partial(
        _encode_kernel, n=n, d=d, ds=ds, block_n=block_n, depth=depth,
        n_depth=w.shape[1], k_tile=k_tile, n_tiles=k_pad // k_tile,
        precision=precision,
    )
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, block_n),),
        out_shape=jax.ShapeDtypeStruct((n, m), jnp.dtype(dtype)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="pq_encode",
    )(x.astype(jnp.float32), w, sqn)


def assign_nearest(centroids: Array, x: Array) -> Array:
    """Nearest-centroid assignment via the fused kernel: the k-means
    assign step (reference: ``src/kmeans.rs:133-159``) is PQ encode with a
    single subquantizer.  Returns ``(n,)`` int32."""
    return pq_encode(centroids[None, :, :], x, dtype=jnp.int32)[:, 0]

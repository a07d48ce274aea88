"""ADC lookup-table scoring kernel (Pallas through Triton).

ADC scoring sums ``m`` table entries per (query, database vector):
``score[q, i] = sum_j T[q, j, codes[i, j]]``.  The einsum scorer
(:func:`reductive_tpu.search.adc_scores`) restates each lookup as a
one-hot matrix product, ``2 * m * k`` FLOPs per pair.  Here each program
takes a tile of ``block_q`` queries and ``block_n`` code rows, reads each
code column once, and gathers the table entries straight into an f32
accumulator: ``m`` loads per pair.  The tables of a query tile
(``block_q * m * k * 4`` bytes, 16 KB per query at m=16, k=256) stay hot
in L1/L2 across the code tiles that read them.

``packed=True`` scores a packed-u4 corpus (``(n, m/2)`` bytes from
:func:`reductive_tpu.ops.packing.pack_u4_codes`, ``k <= 16``, even ``m``):
the nibbles are split in registers, so half the code bytes move.

Scores are f32 sums of the f32 table entries, in subquantizer order: they
equal the einsum scorer's up to f32 summation order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import Array
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["adc_scores_kernel"]


def _adc_kernel(t_ref, codes_ref, out_ref, *, n, nq, m, k, block_q, block_n,
                packed):
    i = pl.program_id(0)
    qb = pl.program_id(1)
    rows = pl.ds(i * block_n, block_n)
    row_ok = i * block_n + jnp.arange(block_n, dtype=jnp.int32) < n
    q = qb * block_q + jnp.arange(block_q, dtype=jnp.int32)
    q_ok = q < nq
    mask = q_ok[:, None] & row_ok[None, :]
    base = q[:, None] * (m * k)
    acc = jnp.zeros((block_q, block_n), jnp.float32)
    for j in range(m):
        col = j // 2 if packed else j
        code = plgpu.load(codes_ref.at[rows, col], mask=row_ok,
                          other=0).astype(jnp.int32)
        if packed:
            code = (code >> (4 * (j % 2))) & 0xF
        acc += plgpu.load(t_ref.at[base + (j * k) + code[None, :]],
                          mask=mask, other=0.0)
    plgpu.store(out_ref.at[pl.ds(qb * block_q, block_q), rows], acc,
                mask=mask)


@functools.partial(
    jax.jit, static_argnames=("packed", "block_q", "block_n", "interpret")
)
def adc_scores_kernel(
    tables: Array,
    codes: Array,
    *,
    packed: bool = False,
    block_q: int = 16,
    block_n: int = 64,
    interpret: bool = False,
) -> Array:
    """``(nq, n)`` f32 ADC scores of ``(nq, m, k)`` tables (from
    :func:`reductive_tpu.search.adc_tables`) against ``(n, m)`` uint8
    codes, or ``(n, m/2)`` packed-u4 bytes with ``packed=True``.
    ``block_q``/``block_n`` are tuning knobs;
    ``interpret=True`` runs the Pallas interpreter (CPU tests)."""
    nq, m, k = tables.shape
    n = codes.shape[0]
    if packed:
        if m % 2 != 0:
            raise ValueError(f"packed u4 codes require even m, got {m}")
        if k > 16:
            raise ValueError(f"packed u4 codes require k <= 16, got {k}")
        if codes.ndim != 2 or codes.shape[1] != m // 2:
            raise ValueError(
                f"packed codes have shape {codes.shape}, expected (n, {m // 2})"
            )
    elif codes.ndim != 2 or codes.shape[1] != m:
        raise ValueError(f"codes have shape {codes.shape}, expected (n, {m})")
    if codes.dtype != jnp.uint8:
        raise ValueError(f"the ADC kernel takes uint8 codes, got {codes.dtype}")
    kernel = functools.partial(
        _adc_kernel, n=n, nq=nq, m=m, k=k, block_q=block_q, block_n=block_n,
        packed=packed,
    )
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, block_n), pl.cdiv(nq, block_q)),
        out_shape=jax.ShapeDtypeStruct((nq, n), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="adc_scores",
    )(tables.astype(jnp.float32).reshape(-1), codes)

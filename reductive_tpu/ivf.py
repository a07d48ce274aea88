"""IVF-PQ: inverted-file search with residual product quantization.

Exhaustive ADC scans every code (``reductive_tpu.search``); production
corpora at 100M+ vectors use a **coarse quantizer** to prune the scan:
vectors are bucketed by nearest coarse centroid, PQ-encoded as
**residuals** against that centroid (Jégou et al., 2011, §V — residual
encoding roughly squares the effective codebook resolution), and a query
scores only the ``nprobe`` nearest cells.  The reference ships no search
at all; this is the capability extension that makes the serving story
complete at scale.

Design decisions:

* **Static-shape cells.**  Classic IVF keeps ragged per-cell lists —
  hostile to XLA.  Here every cell is a fixed-capacity row block of one
  dense ``(C, L, m)`` code tensor plus ``(C, L)`` ids (``-1`` = empty
  slot, masked at score time).  ``L`` defaults to the build-time maximum
  cell size, so nothing spills and the memory overhead is bounded by the
  cell-balance ratio (the coarse k-means keeps that small on real data).
* **IVFADC scoring.**  Scores use the decomposition
  ``||q - c - rec||^2 = ||q||^2 + g - 2 q.c - 2 q.rec`` (Jégou et al.,
  2011, Eq. 13) with ``g = ||c + rec||^2`` precomputed at build time.
  ``q.rec`` comes from per-query lookup tables scored by the GPU ADC
  kernel over the union of probed cells (:func:`_probe_and_score_lut`),
  or, on the plain path, from a gather-decode of the probed candidates
  and one batched dot (:func:`_probe_and_score`).
* **Everything under one jit** with static ``(nprobe, top_k, L)`` — no
  data-dependent shapes anywhere; :func:`ivf_search_sharded` shards the
  cells over a mesh with a tiny ``(nq, top_k)`` all-gather merge.

Build runs its distance, encode, and norm passes on device, streaming
only the tiny per-batch codes/norms back for a host-side vectorized
scatter into the dense cells; bounded-capacity builds never lose rows
silently (``on_overflow="spill"|"error"|"drop"``).  Training reuses the
library's own k-means and chunked PQ trainers.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import Array

from .pq.model import Pq

logger = logging.getLogger("reductive_tpu")

__all__ = [
    "IvfPq", "train_ivf_pq", "build_ivf", "ivf_add", "ivf_remove",
    "ivf_search", "ivf_search_sharded",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class IvfPq:
    """An IVF-PQ index: coarse centroids + residual PQ + dense cells.

    ``cell_codes[c, l]`` is the PQ code of the ``l``-th vector assigned to
    coarse cell ``c`` (encoded from the residual ``x - centroid[c]``);
    ``cell_ids[c, l]`` is its original corpus row, or ``-1`` for an empty
    slot.  A registered pytree — flows through jit/shard_map and
    checkpoints like any parameter structure.  :func:`build_ivf`
    additionally sets a ``dropped_ids`` numpy attribute (build metadata,
    not a pytree leaf): the corpus rows dropped under
    ``on_overflow="drop"``, empty otherwise.
    """

    coarse_centroids: Array  # (C, d)
    pq: Pq                   # residual quantizer, codebooks (m, k, ds)
    cell_codes: Array        # (C, L, m) uint8/uint16
    cell_ids: Array          # (C, L) int32, -1 = empty
    cell_norms: Array        # (C, L) f32: ||centroid + recon(code)||^2

    @property
    def n_cells(self) -> int:
        return self.coarse_centroids.shape[0]

    @property
    def capacity(self) -> int:
        return self.cell_codes.shape[1]

    @property
    def packed(self) -> bool:
        """True when cell codes are nibble-packed (``build_ivf(packed=
        True)``, k <= 16): ``cell_codes`` is ``(C, L, m/2)`` bytes in the
        :func:`reductive_tpu.ops.pack_u4_codes` layout.  Inferred from
        the shape, so packed indexes round-trip through ``io.save``/
        ``load`` and shard like unpacked ones."""
        return self.cell_codes.shape[2] != self.pq.quantized_len


def train_ivf_pq(
    key: Array,
    instances: Array,
    n_cells: int,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    *,
    coarse_iterations: int = 10,
    pq_iterations: int = 10,
    train_sample: Optional[int] = 262_144,
    chunk: int = 32768,
    use_kernel: Optional[bool] = None,
    residual_quantizer: str = "pq",
    coarse_metric: str = "l2",
) -> Tuple[Array, Pq]:
    """Train the two quantization stages: coarse k-means centroids and a
    PQ over the **residuals** ``x - centroid[assign(x)]``.

    Reuses the library's own machinery — the chunked Lloyd's driver for
    the coarse stage and :func:`train_pq_chunked` for the residual PQ.
    ``train_sample`` caps the rows used for training (both stages are
    statistical; a quarter-million rows train 4096 cells well); the full
    corpus is only touched at :func:`build_ivf` time.  ``instances`` may
    be a reader (see :func:`build_ivf`) for corpora larger than HBM — the
    training sample is fetched row-wise from disk and only it occupies
    device memory.

    ``residual_quantizer="gaussian_opq"`` learns a closed-form OPQ
    rotation for the residual space (residual distributions are roughly
    Gaussian, so the cheap closed-form variant fits); the returned model
    carries the projection and both :func:`build_ivf` and
    :func:`ivf_search` honor it transparently.

    ``coarse_metric="spherical"`` trains **spherical k-means** for the
    coarse stage (centroids re-normalized to the unit sphere after every
    Lloyd's update) — the standard coarse quantizer for cosine-regime
    corpora: cells become directional cones, which is what
    ``ivf_search(metric="dot")`` probes by.  Use with an L2-normalized
    corpus; the default ``"l2"`` is the plain Euclidean trainer.
    """
    from .kmeans import (
        KMeansPlusPlusCentroids,
        kmeans_with_centroids_chunked,
        random_distinct_indices,
    )
    from .pq.train import train_pq_chunked

    if _is_reader(instances):
        # On-disk corpus (>HBM): both training stages run on a sampled
        # device-resident subset, so only the sample crosses to HBM.
        n, d = instances.n, instances.dim
        kc, ks, kp = jax.random.split(key, 3)
        cap = min(train_sample or 262_144, n - 1)
        idx = np.sort(np.asarray(random_distinct_indices(ks, n, cap)))
        x_train = jnp.asarray(_reader_rows(instances, idx))
    else:
        n, d = instances.shape
        kc, ks, kp = jax.random.split(key, 3)
        x_train = instances
        if train_sample is not None and n > train_sample:
            idx = random_distinct_indices(ks, n, train_sample)
            x_train = jnp.take(instances, idx, axis=0)

    logger.info(
        "IVF-PQ training: %d coarse cells (%d iters) + residual PQ m=%d k=%d",
        n_cells, coarse_iterations, n_subquantizers, 2 ** n_subquantizer_bits,
    )
    # k-means++ seeding: random-instance init leaves dead/merged coarse
    # centroids (coupon-collector), which skews cell sizes — and the
    # dense-cell capacity (hence probe cost) scales with the LARGEST
    # cell.  D^2-weighted seeding keeps max/mean cell size small.
    if coarse_metric not in ("l2", "spherical"):
        raise ValueError(
            f"unknown coarse_metric {coarse_metric!r} "
            '(use "l2" or "spherical")'
        )
    init = KMeansPlusPlusCentroids()(kc, x_train, n_cells)
    if coarse_metric == "spherical":
        # Spherical k-means: one Lloyd's update, then project centroids
        # back to the unit sphere (Dhillon & Modha, 2001).  Assignment by
        # nearest-L2 on unit vectors == assignment by largest cosine, so
        # the standard iteration machinery applies unchanged between
        # normalizations.  Empty clusters (zero vectors) stay zero.
        coarse = init / jnp.maximum(
            jnp.linalg.norm(init, axis=1, keepdims=True), 1e-30
        )
        for _ in range(coarse_iterations):
            coarse, _ = kmeans_with_centroids_chunked(
                x_train, coarse, 1, chunk=chunk, use_kernel=use_kernel,
            )
            norm = jnp.linalg.norm(coarse, axis=1, keepdims=True)
            coarse = jnp.where(norm > 0, coarse / jnp.maximum(norm, 1e-30),
                               coarse)
    else:
        coarse, _ = kmeans_with_centroids_chunked(
            x_train, init, coarse_iterations,
            chunk=chunk, use_kernel=use_kernel,
        )

    residuals = x_train - jnp.take(
        coarse, _assign_coarse(coarse, x_train, use_kernel), axis=0
    )
    if residual_quantizer == "pq":
        pq = train_pq_chunked(
            kp, residuals, n_subquantizers, n_subquantizer_bits, pq_iterations,
            chunk=chunk, use_kernel=use_kernel,
        )
    elif residual_quantizer == "gaussian_opq":
        from .pq.opq import train_gaussian_opq_chunked

        pq = train_gaussian_opq_chunked(
            kp, residuals, n_subquantizers, n_subquantizer_bits, pq_iterations,
            chunk=chunk, use_kernel=use_kernel,
        )
    else:
        raise ValueError(
            f"unknown residual_quantizer {residual_quantizer!r} "
            '(use "pq" or "gaussian_opq")'
        )
    return coarse, pq


def _assign_coarse(coarse: Array, x: Array, use_kernel: Optional[bool]) -> Array:
    """Nearest coarse cell per row: the encode kernel with one
    subquantizer, or the chunked einsum."""
    from .dispatch import use_kernel as choose

    C = coarse.shape[0]
    if choose("encode", use_kernel):
        from .ops import assign

        return assign.assign_nearest(coarse, x)
    from .kmeans import cluster_assignments

    # The einsum materializes an (n, C) distance block; chunk it the same
    # way build_ivf's pass 1 caps its batch (~256 MB of f32) so assigning
    # a 262k-row sample against 4096 cells does not allocate a 4.3 GB
    # temporary in one shot.
    n = x.shape[0]
    b = max(8192, (1 << 26) // max(1, C))
    if n <= b:
        return cluster_assignments(coarse, x)
    out = np.empty(n, np.int32)
    for off in range(0, n, b):
        out[off : off + b] = np.asarray(_coarse_topk(x[off : off + b], coarse, 1)[:, 0])
    return jnp.asarray(out)


def _is_reader(instances) -> bool:
    """A corpus source is either a device/host array or a reader object
    (``reductive_tpu.native.VecsReader`` or anything with ``n``/``dim``/
    ``read``) for corpora larger than HBM."""
    return not hasattr(instances, "shape") and hasattr(instances, "read")


def _reader_rows(reader, rows: np.ndarray) -> np.ndarray:
    if hasattr(reader, "read_rows"):
        return reader.read_rows(rows)
    return np.concatenate([reader.read(int(i), 1) for i in rows])


@functools.partial(jax.jit, static_argnames=("A",))
def _coarse_topk(xb: Array, coarse: Array, A: int) -> Array:
    """Indices of the ``A`` nearest coarse centroids per row (fused under
    jit so the distance temporaries never outlive the call).  ``A == 1``
    lowers to argmin — same first-index tie-break as ``top_k``, and
    several-fold cheaper to compile and run at large ``(n, C)``."""
    from .linalg import squared_euclidean_distance

    d2 = squared_euclidean_distance(xb, coarse)
    if A == 1:
        return jnp.argmin(d2, axis=1).astype(jnp.int32)[:, None]
    _, top = jax.lax.top_k(-d2, A)
    return top


@functools.partial(jax.jit, static_argnames=("inner",))
def _assign_block(xb: Array, coarse: Array, inner: int) -> Array:
    """Nearest coarse cell for one large batch, chunked internally with
    ``lax.map`` so the ``(inner, C)`` distance transient stays bounded —
    ONE device dispatch per megarow batch instead of thousands of tiny
    host-driven calls (at large C the transient cap would otherwise
    shrink the batch to ~16k rows)."""
    b, d = xb.shape
    main = (b // inner) * inner
    out = []
    if main:
        out.append(
            jax.lax.map(
                lambda xc: _coarse_topk(xc, coarse, 1)[:, 0],
                xb[:main].reshape(-1, inner, d),
            ).reshape(-1)
        )
    if main < b:
        out.append(_coarse_topk(xb[main:], coarse, 1)[:, 0])
    return out[0] if len(out) == 1 else jnp.concatenate(out)


# In-place write of a block of rows into a resident device buffer.  One
# module-level jit: a jit made inside the build would trace and compile
# again on every call.
_write_rows = jax.jit(
    lambda buf, off, v: jax.lax.dynamic_update_slice(
        buf, v, (off,) + (jnp.zeros((), off.dtype),) * (buf.ndim - 1)
    ),
    donate_argnums=(0,),
)


def _greedy_place(
    cands: np.ndarray, C: int, L: int, fill: Optional[np.ndarray] = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """First-come greedy placement of each row into the nearest of its
    candidate cells with free space.  ``cands`` is ``(n, A)`` candidate
    cells in preference order.  Returns ``(cell, slot, fill)`` per row,
    ``-1`` where no candidate had space; ``fill`` (cell occupancy, updated
    in place when passed) lets a later spill pass continue where an
    earlier bounded pass stopped.  Vectorized: one stable grouping pass
    per candidate rank."""
    n, A = cands.shape
    cell = np.full(n, -1, np.int64)
    slot = np.full(n, -1, np.int64)
    if fill is None:
        fill = np.zeros(C, np.int64)
    for r in range(A):
        unplaced = np.where(cell < 0)[0]
        if len(unplaced) == 0:
            break
        cand_r = cands[unplaced, r]
        order = np.argsort(cand_r, kind="stable")  # corpus order within cell
        grouped = cand_r[order]
        group_start = np.concatenate([[0], np.where(np.diff(grouped))[0] + 1])
        starts_of = np.zeros(len(grouped), np.int64)
        starts_of[group_start] = group_start
        np.maximum.accumulate(starts_of, out=starts_of)
        rank_in_group = np.arange(len(grouped)) - starts_of
        space = L - fill[grouped]
        accept = rank_in_group < space
        rows = unplaced[order[accept]]
        cell[rows] = grouped[accept]
        slot[rows] = fill[grouped[accept]] + rank_in_group[accept]
        np.add.at(fill, grouped[accept], 1)
    return cell, slot, fill


def _spill_place(
    remaining: np.ndarray,
    coarse: Array,
    fetch_rows,
    C: int,
    L: int,
    fill: np.ndarray,
    cell_of: np.ndarray,
    slot_of: np.ndarray,
) -> None:
    """Final placement pass for rows that fit none of their candidate
    cells: each is placed in the nearest cell *anywhere* with free space.
    Ranks only the cells that still have space (usually a small subset);
    rows whose ranked cells fill up mid-pass retry against the shrunken
    space set — each pass places at least the earliest-ordered rows, so
    this terminates.  Mutates ``fill``/``cell_of``/``slot_of``."""
    while len(remaining):
        space_cells = np.where(fill < L)[0]
        sub = jnp.take(coarse, space_cells.astype(np.int32), axis=0)
        Asp = int(min(len(space_cells), 16))
        bf = max(8192, (1 << 26) // max(1, len(space_cells)))
        csp = np.empty((len(remaining), Asp), np.int64)
        for off in range(0, len(remaining), bf):
            rows = remaining[off : off + bf]
            csp[off : off + bf] = np.asarray(
                _coarse_topk(fetch_rows(rows), sub, Asp)
            )
        cands_sp = space_cells[csp]  # map back to global cell ids
        cell_sp, slot_sp, fill = _greedy_place(cands_sp, C, L, fill)
        ok = cell_sp >= 0
        cell_of[remaining[ok]] = cell_sp[ok]
        slot_of[remaining[ok]] = slot_sp[ok]
        remaining = remaining[~ok]


def _respill_device(
    positions: np.ndarray,
    coarse: Array,
    fetch_rows,
    C: int,
    L: int,
    fill: np.ndarray,
    rounds: int = 64,
) -> Tuple[Array, Array, np.ndarray]:
    """Device-side nearest-cell-with-space placement for the bounded-
    capacity overflow.  Returns ``(cell, slot, remaining)`` where
    ``cell``/``slot`` are DEVICE int32 arrays aligned with ``positions``
    (``-1`` where unplaced) and ``remaining`` is the (normally empty)
    unplaced subset of ``positions`` for the host fallback.  Mutates
    ``fill`` to the post-placement occupancy.

    Two earlier designs motivated this one.  The host greedy pass
    (:func:`_spill_place`) walks candidate ranks with per-batch device
    round trips, which dominate when a skewed corpus overflows a large
    share of its rows.  The first device version
    recomputed full ``(rows, C)`` distances each round over the
    SHRINKING remainder: every round's new shapes recompiled the whole
    round program, and per-round numpy transfers of the placement state
    paid the host link again (240 s for a 336k-row spill).  Here the
    loop state (occupancy, placed cell/slot) lives on device with STATIC
    shapes — one compiled round program serves every round, and the host
    sees one scalar (rows left) per round:

    1. one batched pass caches each overflow row's ``T`` nearest cells
       (``T`` sized so the cache stays ~1 GB even at a 30M-row spill);
    2. each round, a row targets its first cached candidate with free
       space; a stable argsort groups contenders so ``rank = pos -
       starts[target]`` hands out the cell's remaining slots in corpus
       order (the host greedy's priority); losers retry next round
       against the updated occupancy;
    3. when every remaining row's cached candidates are full (no
       progress), candidates are re-drawn against only the cells that
       still have space — the same target set as the host pass — and the
       rounds continue.  Total free capacity >= remaining rows (checked
       by the caller), so each redraw epoch strictly places rows and the
       loop terminates."""
    P = len(positions)
    pc = jnp.full((max(P, 1),), -1, jnp.int32)
    ps = jnp.full((max(P, 1),), -1, jnp.int32)
    if not P:
        return pc[:0], ps[:0], positions
    T = int(min(C, max(4, (1 << 28) // max(P, 1)), 16))

    def draw_candidates(idx: np.ndarray, cells: Optional[np.ndarray]):
        """Top-T nearest (space-)cells for ``positions[idx]``, batched."""
        pos = positions[idx]
        if cells is None:
            sub, n_sub = coarse, C
        else:
            cells_d = jnp.asarray(cells.astype(np.int32))
            sub, n_sub = jnp.take(coarse, cells_d, axis=0), len(cells)
        t = int(min(T, n_sub))
        b2 = max(4096, (1 << 26) // max(1, n_sub))
        parts = []
        for off in range(0, len(pos), b2):
            parts.append(
                _coarse_topk(fetch_rows(pos[off : off + b2]), sub, t)
            )
        cand = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        if cells is not None:
            cand = jnp.take(cells_d, cand)
        if t < T:  # pad to the static width; sentinel C reads free == 0
            cand = jnp.concatenate(
                [cand, jnp.full((len(pos), T - t), C, cand.dtype)], axis=1
            )
        return cand.astype(jnp.int32)

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
    def one_round(fill_d, pc, ps, cand):
        # free carries a sentinel 0 at index C: padded candidates and
        # parked targets never claim a slot.
        free = jnp.concatenate(
            [jnp.int32(L) - fill_d, jnp.zeros((1,), jnp.int32)]
        )
        ok = jnp.take(free, cand) > 0  # (P, T)
        has = jnp.any(ok, axis=1) & (pc < 0)
        first = jnp.argmax(ok, axis=1)
        tgt = jnp.where(
            has,
            jnp.take_along_axis(cand, first[:, None], axis=1)[:, 0],
            jnp.int32(C),
        )
        order = jnp.argsort(tgt, stable=True)  # parked rows sort last
        t_sorted = jnp.take(tgt, order)
        counts = jnp.bincount(tgt, length=C)
        starts = jnp.concatenate(
            [jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)[:-1]]
        )
        rank_sorted = (
            jnp.arange(P, dtype=jnp.int32)
            - jnp.take(starts, jnp.clip(t_sorted, 0, C - 1)).astype(
                jnp.int32
            )
        )
        rank = jnp.take(rank_sorted, jnp.argsort(order))
        accept = has & (rank < jnp.take(free, tgt))
        tgt_c = jnp.clip(tgt, 0, C - 1)
        slot = jnp.take(fill_d, tgt_c) + rank
        pc = jnp.where(accept, tgt, pc)
        ps = jnp.where(accept, slot, ps)
        placed = jnp.bincount(
            jnp.where(accept, tgt, jnp.int32(C)), length=C
        )
        fill_d = fill_d + placed.astype(fill_d.dtype)
        return fill_d, pc, ps, jnp.sum(pc < 0)

    fill_d = jnp.asarray(fill.astype(np.int32))
    cand = draw_candidates(np.arange(P), None)
    iota = jnp.arange(P, dtype=jnp.int32)

    def left_indices(pc, n_left):
        """Unplaced indices without transferring the full mask: sort
        parks placed rows (sentinel P) at the tail, slice to n_left."""
        idx = jnp.sort(jnp.where(pc < 0, iota, jnp.int32(P)))[:n_left]
        return np.asarray(idx).astype(np.int64)

    prev_left, redraws, n_left = P + 1, 0, P
    for _ in range(rounds):
        fill_d, pc, ps, left = one_round(fill_d, pc, ps, cand)
        n_left = int(left)
        if n_left == 0:
            break
        if n_left == prev_left:  # every cached candidate is full: redraw
            space = np.where(np.asarray(fill_d) < L)[0]
            if len(space) == 0 or redraws >= 8:
                break
            idx_left = left_indices(pc, n_left)
            cand = cand.at[jnp.asarray(idx_left.astype(np.int32))].set(
                draw_candidates(idx_left, space)
            )
            redraws += 1
            prev_left = P + 1
        else:
            prev_left = n_left

    fill[:] = np.asarray(fill_d).astype(fill.dtype)
    remaining = (
        positions[left_indices(pc, n_left)] if n_left else positions[:0]
    )
    return pc, ps, remaining


@functools.partial(jax.jit, static_argnames=("use_kernel", "out_dtype"))
def _residual_encode_batch(
    coarse: Array, pq: Pq, xb: Array, cc: Array, use_kernel: bool, out_dtype
) -> Tuple[Array, Array]:
    """Residual-encode one batch against its placed centroids and compute
    the IVFADC approximation norms ``g = ||centroid + recon||^2`` — all on
    device, so only ``(b, m)`` uint8 codes and ``(b,)`` f32 norms cross
    back to the host."""
    from .dispatch import encode

    c = jnp.take(coarse, cc, axis=0)
    rb = xb - c
    if pq.projection is not None:
        rb = jnp.dot(rb, pq.projection, precision="highest")
    codes = encode(pq.codebooks, rb, dtype=out_dtype, use_kernel=use_kernel)
    full = c + pq.reconstruct_batch(codes)
    norms = jnp.einsum("nd,nd->n", full, full, precision="highest")
    return codes, norms


def _scatter_updates_impl(cell_codes, cell_ids, cell_norms,
                          cc, ss, codes, ids, norms):
    """Scatter one add-batch into the resident cell tensors on device."""
    return (
        cell_codes.at[cc, ss].set(codes),
        cell_ids.at[cc, ss].set(ids.astype(cell_ids.dtype)),
        cell_norms.at[cc, ss].set(norms.astype(cell_norms.dtype)),
    )


# Copy-on-write variant (functional default: the input index stays valid)
# and a donating variant (in-place buffer reuse for high-rate streaming
# updates — the input index's cell tensors are CONSUMED).
_scatter_updates = jax.jit(_scatter_updates_impl)
_scatter_updates_donated = jax.jit(_scatter_updates_impl,
                                   donate_argnums=(0, 1, 2))


def _build_ivf_device(
    coarse: Array,
    pq: Pq,
    instances,
    *,
    capacity,
    on_overflow: str,
    dtype,
    batch: int,
    use_kernel: bool,
    packed: bool,
) -> IvfPq:
    """Fully device-side cell construction: placement, slot assignment,
    and the cell scatter never leave HBM.

    The host path (:func:`build_ivf` ``placement="host"``) streams the
    per-row candidates and codes back for a host scatter — O(n·m) bytes
    of device-to-host traffic (~2.5 GB of codes at 100M rows).  Here the
    only host crossings are a handful of scalars plus the (rare) overflow
    rows:

    1. one assignment pass accumulates each row's nearest cell on device;
    2. a stable argsort groups rows by cell; ``rank = pos − starts[cell]``
       numbers each row within its cell in corpus order, as the host
       greedy pass does;
    3. the ``(C·L,)`` ``slot_to_row`` map is pure gathers (no scatter
       anywhere: ``row = order[starts[c] + l]`` where occupied, ``-1``
       holes elsewhere);
    4. the encode pass stores ``(n, m)`` codes + norms on device; the
       final cell tensors are three gathers through ``slot_to_row``.

    Bounded capacity: rows ranked past ``L`` in their nearest cell (the
    overflow — a few % on k-means++-balanced cells at the default 1.25x
    provisioning) are compacted on device, and only they take the host
    spill path (nearest cell with space, re-encoded against the storage
    cell), scattered back with the :func:`ivf_add` machinery.  Unlike the
    host greedy pass there is no intermediate "next-A-candidates" tier —
    in-capacity rows always sit in their TRUE nearest cell (slightly
    better probe quality), overflow goes straight to nearest-with-space.
    """
    is_reader = _is_reader(instances)
    n, d = (instances.n, instances.dim) if is_reader else instances.shape
    C = coarse.shape[0]
    m = pq.quantized_len

    def fetch_slice(off: int, b: int):
        if is_reader:
            return jnp.asarray(instances.read(off, min(b, n - off)))
        return instances[off : off + b]

    import time as _time

    def _mark(stage, t0):
        if logger.isEnabledFor(logging.INFO):
            logger.info("IVF device build: %s %.1fs", stage,
                        _time.perf_counter() - t0)
        return _time.perf_counter()

    t0 = _time.perf_counter()
    # Pass 1: nearest cell per row, accumulated on device.  Full
    # `batch`-row dispatches with lax.map chunking inside: at large C the
    # (rows, C) transient cap must not shrink the HOST batch (a 16k-row
    # batch at C=16384 means 6400 dispatches over 100M rows).
    inner = max(4096, min(batch, (1 << 26) // max(1, C)))
    assign = jnp.zeros((n,), jnp.int32)
    for i, off in enumerate(range(0, n, batch)):
        a = _assign_block(fetch_slice(off, batch), coarse, inner)
        assign = _write_rows(assign, jnp.int32(off), a)
        if i % 2 == 1:  # bound async-dispatch depth (transient gen batch)
            jax.block_until_ready(assign)
    jax.block_until_ready(assign)
    t0 = _mark("assign pass", t0)

    counts = jnp.bincount(assign, length=C)
    if capacity is None:
        L = int(jnp.max(counts))
    elif capacity == "auto":
        L = int(np.ceil(1.25 * n / C))
    else:
        L = int(capacity)

    starts = jnp.concatenate(
        [jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)[:-1]]
    )
    order = jnp.argsort(assign, stable=True).astype(jnp.int32)
    pos = jnp.arange(n, dtype=jnp.int32)
    rank = pos - jnp.take(starts, jnp.take(assign, order)).astype(jnp.int32)
    cap_counts = jnp.minimum(counts, L)
    n_over = int(n - jnp.sum(cap_counts))

    over_rows = np.empty(0, np.int64)
    if n_over:
        if on_overflow == "error":
            raise ValueError(
                f"IVF build: {n_over} rows exceed their nearest cell's "
                f"capacity {L}; raise capacity/n_cells, or use "
                f'on_overflow="spill"'
            )
        if on_overflow == "spill" and C * L - (n - n_over) < n_over:
            raise ValueError(
                f"IVF build: total capacity C*L = {C * L} < n = {n}; "
                f"no spill placement exists — raise capacity"
            )
        # Scatter-free compaction of the overflow rows: sort the masked
        # row ids (pads land at the tail) — a plain sort, where a
        # top_k with k = n_over compiled and ran far slower at large
        # overflow counts.  Ascending corpus order matches the host
        # pass's spill ordering.
        over_rows = np.asarray(
            jnp.sort(jnp.where(rank >= L, order, jnp.int32(n)))[:n_over]
        ).astype(np.int64)

    # slot_to_row: pure gathers.  Occupied slot (c, l) holds the l-th row
    # (in corpus order) assigned to cell c; holes are -1.
    flat = jnp.arange(C * L, dtype=jnp.int32)
    flat_c, flat_l = flat // L, flat % L
    occupied = flat_l < jnp.take(cap_counts, flat_c)
    src = jnp.take(starts, flat_c).astype(jnp.int32) + flat_l
    slot_to_row = jnp.where(
        occupied, jnp.take(order, jnp.clip(src, 0, n - 1)), -1
    )
    del order, rank, pos, starts, flat, flat_c, flat_l, src
    jax.block_until_ready(slot_to_row)
    t0 = _mark(f"placement (n_over={n_over})", t0)

    # Pass 2: residual encode against the nearest cell; codes/norms stay
    # on device.
    mb = m // 2 if packed else m
    codes_buf = jnp.zeros((n, mb), dtype)
    norms_buf = jnp.zeros((n,), jnp.float32)
    if packed:
        from .ops.packing import pack_u4_codes
    for i, off in enumerate(range(0, n, batch)):
        b = min(batch, n - off)
        cc = jax.lax.dynamic_slice(assign, (off,), (b,))
        codes_b, norms_b = _residual_encode_batch(
            coarse, pq, fetch_slice(off, batch), cc, use_kernel,
            jnp.dtype(dtype),
        )
        if packed:
            codes_b = pack_u4_codes(codes_b)
        codes_buf = _write_rows(codes_buf, jnp.int32(off), codes_b)
        norms_buf = _write_rows(norms_buf, jnp.int32(off), norms_b)
        if i % 2 == 1:
            jax.block_until_ready(codes_buf)
    del assign
    jax.block_until_ready(codes_buf)
    t0 = _mark("encode pass", t0)

    rows_c = jnp.clip(slot_to_row, 0, n - 1)
    cell_codes = jnp.where(
        occupied[:, None], jnp.take(codes_buf, rows_c, axis=0), 0
    ).reshape(C, L, mb)
    cell_ids = slot_to_row.reshape(C, L)
    cell_norms = jnp.where(
        occupied, jnp.take(norms_buf, rows_c), 0.0
    ).reshape(C, L)
    del codes_buf, norms_buf, slot_to_row, rows_c, occupied
    jax.block_until_ready(cell_norms)
    t0 = _mark("cell gather", t0)

    index = IvfPq(
        coarse_centroids=coarse, pq=pq, cell_codes=cell_codes,
        cell_ids=cell_ids, cell_norms=cell_norms,
    )
    index.dropped_ids = np.empty(0, np.int64)

    if n_over and on_overflow == "drop":
        index.dropped_ids = over_rows
        logger.warning(
            "IVF build: %d rows exceeded their nearest cell's capacity %d "
            "and were dropped (ids on index.dropped_ids)", n_over, L,
        )
    elif n_over:  # spill via the host machinery, scatter back on device
        def fetch_over(rows: np.ndarray):
            g = over_rows[rows]
            if is_reader:
                return jnp.asarray(_reader_rows(instances, g))
            return jnp.take(instances, g.astype(np.int32), axis=0)

        fill = np.asarray(cap_counts).astype(np.int64)

        def fetch_rows_global(rows: np.ndarray):
            if is_reader:
                return jnp.asarray(_reader_rows(instances, rows))
            return jnp.take(instances, rows.astype(np.int32), axis=0)

        # Device rounds place (nearly) everything; the placements stay
        # on device so the re-encode and the final scatter never
        # round-trip the O(n_over) placement arrays through the host
        # link.  Positions map through over_rows because the fetch wants
        # corpus rows.
        pc_d, ps_d, pos_left = _respill_device(
            np.arange(n_over), coarse,
            lambda p: fetch_rows_global(over_rows[p]), C, L, fill,
        )
        if len(pos_left):
            cell_of = np.full(n_over, -1, np.int64)
            slot_of = np.full(n_over, -1, np.int64)
            _spill_place(pos_left, coarse, fetch_over, C, L, fill,
                         cell_of, slot_of)
            sel = jnp.asarray(pos_left.astype(np.int32))
            pc_d = pc_d.at[sel].set(
                jnp.asarray(cell_of[pos_left].astype(np.int32))
            )
            ps_d = ps_d.at[sel].set(
                jnp.asarray(slot_of[pos_left].astype(np.int32))
            )
        codes_parts, norms_parts = [], []
        for off in range(0, n_over, batch):
            rows = np.arange(off, min(off + batch, n_over))
            cc_b = jax.lax.dynamic_slice(pc_d, (off,), (len(rows),))
            codes_b, norms_b = _residual_encode_batch(
                coarse, pq, fetch_over(rows), cc_b,
                use_kernel, jnp.dtype(dtype),
            )
            if packed:
                codes_b = pack_u4_codes(codes_b)
            codes_parts.append(codes_b)
            norms_parts.append(norms_b)
        cell_codes, cell_ids, cell_norms = _scatter_updates_donated(
            index.cell_codes, index.cell_ids, index.cell_norms,
            pc_d, ps_d,
            jnp.concatenate(codes_parts, axis=0),
            jnp.asarray(over_rows.astype(np.int32)),
            jnp.concatenate(norms_parts, axis=0),
        )
        index = IvfPq(
            coarse_centroids=coarse, pq=pq, cell_codes=cell_codes,
            cell_ids=cell_ids, cell_norms=cell_norms,
        )
        index.dropped_ids = np.empty(0, np.int64)
        jax.block_until_ready(index.cell_norms)
        t0 = _mark(f"spill ({n_over} rows)", t0)
        logger.info(
            "IVF build (device): %d rows spilled to the nearest cell with "
            "free space", n_over,
        )

    logger.info(
        "IVF build (device): %d rows -> %d cells, capacity %d (util %.0f%%)",
        n, C, L, 100.0 * (n - len(index.dropped_ids)) / (C * L),
    )
    return index


def build_ivf(
    coarse: Array,
    pq: Pq,
    instances: Array,
    *,
    capacity: Optional[int | str] = None,
    overflow_candidates: int = 4,
    on_overflow: str = "spill",
    dtype=jnp.uint8,
    batch: int = 262_144,
    use_kernel: Optional[bool] = None,
    packed: bool = False,
    placement: str = "host",
) -> IvfPq:
    """Assign, residual-encode, and scatter the corpus into dense cells.

    Streaming device passes (``batch`` rows at a time: coarse
    distances/assignment, then residual PQ encode + approximation norms,
    both fully on device); where the cells are built is set by
    ``capacity`` and ``placement`` below.

    ``instances`` may be a device/host ``(n, d)`` array **or a reader**
    (:class:`reductive_tpu.native.VecsReader` or anything with
    ``n``/``dim``/``read``): with a reader the corpus is streamed from
    disk twice (assignment pass, then encode pass) and never resides in
    HBM — the build path for corpora larger than device memory
    (BASELINE config #5).  Only the ``(C, L, m)`` cells plus per-batch
    staging cross through memory.

    ``capacity`` controls the cell size ``L`` — and with it both memory
    and probe cost (a probe always scans ``L`` slots):

    * ``None`` — ``L`` = the largest cell; nothing moves or drops.  Each
      row sits in its nearest cell in corpus order, so no placement
      choice is left: the cells are always built on device
      (:func:`_build_ivf_device`), whatever ``placement`` says.
    * ``"auto"`` — ``L = ceil(1.25 * n / C)``; rows overflowing their
      nearest cell are placed in the nearest of their next
      ``overflow_candidates`` cells with space and residual-encoded
      against *that* centroid (their approximation degrades slightly;
      they are found when their storage cell is probed).  On k-means++-
      balanced cells this cuts probe cost ~3x vs worst-cell padding.
    * an int — explicit ``L``; same overflow placement.

    ``on_overflow`` decides the fate of rows that fit none of their
    ``overflow_candidates`` nearest cells (a bounded-capacity build can
    never lose data silently):

    * ``"spill"`` (default) — a final pass places each leftover row in
      the nearest cell *anywhere* with free space; raises ``ValueError``
      only when total capacity ``C * L < n`` (impossible under
      ``"auto"``, which always provisions 1.25x).
    * ``"error"`` — raise ``ValueError`` listing the overflow count.
    * ``"drop"`` — the round-2 behavior: log a warning and drop the
      rows; their corpus ids are exposed programmatically as the
      ``dropped_ids`` numpy attribute on the returned index so pipelines
      that don't read logs can still detect an incomplete index.

    ``packed=True`` (4-bit residual quantizers only: ``k <= 16``, ``m``
    even) stores the cells nibble-packed — ``cell_codes`` becomes
    ``(C, L, m/2)`` bytes in the :func:`reductive_tpu.ops.pack_u4_codes`
    layout, halving the dominant HBM tensor (~2x corpus per card) and
    the probe-gather traffic.  Search unpacks the gathered candidates
    in-flight (exact nibble arithmetic), so scores are **bit-equal** to
    the unpacked index; :func:`ivf_add`/:func:`ivf_remove` handle packed
    indexes transparently.

    ``placement`` selects where a bounded-capacity build runs:

    * ``"host"`` (default) — candidate greedy placement over
      ``overflow_candidates`` cells, with a host-side vectorized scatter
      of the ``(n, m)`` codes and norms into the cells.
    * ``"device"`` — :func:`_build_ivf_device`: placement, slot
      assignment, and the cell scatter never leave HBM; only overflow
      rows touch the host.  O(n·m) device-to-host traffic drops to
      O(overflow) — the 100M-row build path.  In-capacity rows always
      sit in their true nearest cell (no next-A-candidates tier).

    ``use_kernel`` is resolved by :func:`reductive_tpu.dispatch.use_kernel`
    for the residual encode.
    """
    if placement not in ("host", "device"):
        raise ValueError(
            f'placement must be "host" or "device", got {placement!r}'
        )
    if on_overflow not in ("spill", "error", "drop"):
        raise ValueError(
            f'on_overflow must be "spill", "error", or "drop", '
            f"got {on_overflow!r}"
        )
    is_reader = _is_reader(instances)
    if is_reader:
        n, d = instances.n, instances.dim
    else:
        n, d = instances.shape
    C = coarse.shape[0]
    m = pq.quantized_len
    from .dispatch import use_kernel as choose

    use_kernel = choose("encode", use_kernel)
    if packed:
        if pq.n_quantizer_centroids > 16:
            raise ValueError(
                f"packed=True requires 4-bit codes (k <= 16), got "
                f"k={pq.n_quantizer_centroids}"
            )
        if m % 2 != 0:
            raise ValueError(f"packed=True requires even m, got {m}")
        if jnp.dtype(dtype) != jnp.uint8:
            raise ValueError("packed=True requires dtype=uint8")
    if placement == "device" or capacity is None:
        return _build_ivf_device(
            coarse, pq, instances, capacity=capacity,
            on_overflow=on_overflow, dtype=dtype, batch=batch,
            use_kernel=use_kernel, packed=packed,
        )

    def fetch_slice(off: int, b: int):
        if is_reader:
            return jnp.asarray(instances.read(off, min(b, n - off)))
        return instances[off : off + b]

    def fetch_rows(rows: np.ndarray):
        if is_reader:
            return jnp.asarray(_reader_rows(instances, rows))
        return jnp.take(instances, rows.astype(np.int32), axis=0)

    A = min(overflow_candidates, C)

    # Pass 1: top-A nearest coarse cells per row (one chunked, jitted
    # matmul + top_k).  The batch is capped so the (b, C) distance
    # matrix stays ~1 GB of transients — at C=4096 that is 64k rows per
    # dispatch.  Results accumulate ON DEVICE and cross to the host in
    # ONE fetch: every device-to-host materialization is a synchronizing
    # round trip, and narrow dtype (int16 when C allows) halves the one
    # transfer.
    b1 = max(8192, min(batch, (1 << 28) // max(1, C)))
    tops = [
        _coarse_topk(fetch_slice(off, b1), coarse, A)
        for off in range(0, n, b1)
    ]
    cands_dev = jnp.concatenate(tops, axis=0)
    del tops
    if C <= 32767:
        cands_dev = cands_dev.astype(jnp.int16)
    cands = np.asarray(cands_dev).astype(np.int32)
    del cands_dev

    counts0 = np.bincount(cands[:, 0], minlength=C)
    if capacity == "auto":
        L = int(np.ceil(1.25 * n / C))
    else:
        L = int(capacity)

    cell_of, slot_of, fill = _greedy_place(cands, C, L)
    overflowed = np.where(cell_of < 0)[0]
    dropped_ids = np.empty(0, np.int64)
    if len(overflowed):
        if on_overflow == "error":
            raise ValueError(
                f"IVF build: {len(overflowed)} rows fit none of their {A} "
                f"candidate cells at capacity {L}; raise capacity/n_cells, "
                f'or use on_overflow="spill"'
            )
        if on_overflow == "spill":
            free = C * L - int((cell_of >= 0).sum())
            if free < len(overflowed):
                raise ValueError(
                    f"IVF build: total capacity C*L = {C * L} < n = {n}; "
                    f"no spill placement exists — raise capacity"
                )
            n_spilled = len(overflowed)
            _spill_place(overflowed, coarse, fetch_rows, C, L, fill,
                         cell_of, slot_of)
            logger.info(
                "IVF build: %d rows spilled to the nearest cell with free "
                "space", n_spilled,
            )
        else:  # "drop"
            dropped_ids = overflowed.astype(np.int64)
            logger.warning(
                "IVF build: %d rows fit none of their %d candidate cells at "
                "capacity %d and were dropped (ids on index.dropped_ids); "
                "raise capacity or n_cells",
                len(overflowed), A, L,
            )
    dropped = len(dropped_ids)
    moved = int((cell_of[cell_of >= 0] != cands[cell_of >= 0, 0]).sum())

    # Pass 2: residual encode against the placed centroid + the
    # precomputed approximation norms g = ||centroid + recon||^2 of the
    # IVFADC score decomposition ||q - c - rec||^2 = ||q||^2 + g - 2 q.c
    # - 2 q.rec (Jegou et al., 2011, Eq. 13).  Device-side end to end;
    # the host only scatters (b, m) codes + (b,) norms per batch.
    mb = m // 2 if packed else m  # stored bytes per row
    cell_codes = np.zeros((C, L, mb), dtype=np.dtype(dtype))
    cell_ids = np.full((C, L), -1, dtype=np.int32)
    cell_norms = np.zeros((C, L), np.float32)
    # Same single-fetch discipline as pass 1: per-batch device work
    # (host-to-device index uploads are async and cheap), one
    # device-side concatenation, one (P, m)-codes + one (P,)-norms
    # fetch, then one vectorized host scatter into the cells.
    placed_rows = np.where(cell_of >= 0)[0]
    codes_parts, norms_parts = [], []
    if is_reader:
        # Sequential disk pass in corpus order; unplaced rows (possible
        # only under on_overflow="drop") are filtered on the host and the
        # batch zero-padded back to a single compiled shape.
        placed_mask = cell_of >= 0
        for off in range(0, n, batch):
            sel = placed_mask[off : off + batch]
            v = int(sel.sum())
            if v == 0:
                continue
            xb = instances.read(off, min(batch, n - off))
            cc = cell_of[off : off + batch][sel].astype(np.int32)
            if v < batch:
                xb = np.concatenate(
                    [xb[sel], np.zeros((batch - v, d), np.float32)]
                )
                cc = np.concatenate([cc, np.zeros(batch - v, np.int32)])
            codes_b, norms_b = _residual_encode_batch(
                coarse, pq, jnp.asarray(xb), jnp.asarray(cc),
                use_kernel, jnp.dtype(dtype),
            )
            codes_parts.append(codes_b[:v])
            norms_parts.append(norms_b[:v])
    else:
        for off in range(0, len(placed_rows), batch):
            rows = placed_rows[off : off + batch]
            cc = cell_of[rows]
            codes_b, norms_b = _residual_encode_batch(
                coarse, pq, fetch_rows(rows),
                jnp.asarray(cc.astype(np.int32)),
                use_kernel, jnp.dtype(dtype),
            )
            codes_parts.append(codes_b)
            norms_parts.append(norms_b)
    codes_dev = jnp.concatenate(codes_parts, axis=0)
    if packed:
        from .ops.packing import pack_u4_codes

        codes_dev = pack_u4_codes(codes_dev)  # halves the d2h fetch too
    codes_all = np.asarray(codes_dev)
    norms_all = np.asarray(jnp.concatenate(norms_parts, axis=0))
    del codes_parts, norms_parts, codes_dev
    cc_all = cell_of[placed_rows]
    slots_all = slot_of[placed_rows]
    cell_codes[cc_all, slots_all] = codes_all
    cell_ids[cc_all, slots_all] = placed_rows
    cell_norms[cc_all, slots_all] = norms_all

    logger.info(
        "IVF build: %d rows -> %d cells, capacity %d (mean %.0f, util "
        "%.0f%%, %d rows in secondary cells)",
        n, C, L, counts0.mean(), 100.0 * (n - dropped) / (C * L), moved,
    )
    index = IvfPq(
        coarse_centroids=coarse,
        pq=pq,
        cell_codes=jnp.asarray(cell_codes),
        cell_ids=jnp.asarray(cell_ids),
        cell_norms=jnp.asarray(cell_norms),
    )
    # Build metadata, not part of the pytree: empty unless on_overflow=
    # "drop" actually dropped rows.
    index.dropped_ids = dropped_ids
    return index


@functools.partial(jax.jit, static_argnames=("L",))
def _add_fast_gate(cell_ids: Array, assign: Array, L: int):
    """Device-side placement for an add batch where every new row fits an
    empty slot of its NEAREST cell (the common streaming case).

    Returns ``(overflow, slot)``: ``overflow`` is true when any cell
    would exceed its free slots (the caller then falls back to the host
    greedy/spill path), and ``slot[r]`` is row ``r``'s target empty slot
    in its nearest cell — the ``rank(r)``-th free slot in ascending slot
    order (ranks are batch order within each cell, matching
    :func:`_assign_free_slots`' numbering).  One scalar crosses to the
    host; everything else stays device-resident, which is what lifts the
    streaming-churn ceiling (the host path pays ~3 device round trips per
    batch).
    """
    C = cell_ids.shape[0]
    n_new = assign.shape[0]
    counts_new = jnp.bincount(assign, length=C)
    fill = jnp.sum(cell_ids >= 0, axis=1)
    overflow = jnp.any(counts_new > (L - fill))
    order = jnp.argsort(assign, stable=True).astype(jnp.int32)
    pos = jnp.arange(n_new, dtype=jnp.int32)
    starts = jnp.cumsum(counts_new) - counts_new
    rank_sorted = pos - jnp.take(
        starts, jnp.take(assign, order)
    ).astype(jnp.int32)
    rank = jnp.zeros_like(rank_sorted).at[order].set(rank_sorted)
    # Ascending free-slot order per cell: stable sort of the occupancy
    # mask puts empty slots first, lowest index first.
    free_order = jnp.argsort((cell_ids >= 0).astype(jnp.int32), axis=1,
                             stable=True)
    slot = free_order[assign, jnp.minimum(rank, L - 1)].astype(jnp.int32)
    return overflow, slot


def _assign_free_slots(
    cell_of: np.ndarray, slot_of: np.ndarray, cell_ids: Array
) -> np.ndarray:
    """Map greedy-place virtual slot ranks to *actual* empty slot indices.

    ``_greedy_place`` numbers slots ``fill + rank`` assuming occupancy is
    a prefix of each cell — true for a virgin build, false after
    :func:`ivf_remove` leaves holes.  Re-assign each placed row, in rank
    order, to its cell's real empty slots.

    The occupancy scan runs on device over only the *touched* cells (a
    stable argsort puts each cell's free slots first, in ascending slot
    order), so the resident ``cell_ids`` tensor never crosses to the
    host — only ``(touched, L)`` index rows' worth of sort output and
    the final ``(placed,)`` slot vector do."""
    out = np.full_like(slot_of, -1)
    placed = np.where(cell_of >= 0)[0]
    if not len(placed):
        return out
    order = np.lexsort((slot_of[placed], cell_of[placed]))
    rows = placed[order]
    cells = cell_of[rows]
    # Rank of each row within its (contiguous after the lexsort) cell run.
    starts = np.concatenate([[0], np.where(np.diff(cells))[0] + 1])
    starts_of = np.zeros(len(cells), np.int64)
    starts_of[starts] = starts
    np.maximum.accumulate(starts_of, out=starts_of)
    ranks = np.arange(len(cells)) - starts_of
    touched, tinv = np.unique(cells, return_inverse=True)
    # Device: ascending free-slot order per touched cell.  Stable sort of
    # the occupancy mask puts empty slots (False) first, lowest index
    # first; indexing it at each row's rank yields its real slot.
    occ = jnp.take(cell_ids, jnp.asarray(touched.astype(np.int32)), axis=0)
    free_order = jnp.argsort((occ >= 0).astype(jnp.int32), axis=1,
                             stable=True)
    slots = free_order[jnp.asarray(tinv.astype(np.int32)),
                       jnp.asarray(ranks.astype(np.int32))]
    out[rows] = np.asarray(slots)
    return out


def ivf_add(
    index: IvfPq,
    instances: Array,
    ids: Optional[np.ndarray] = None,
    *,
    overflow_candidates: int = 4,
    on_overflow: str = "spill",
    batch: int = 262_144,
    use_kernel: Optional[bool] = None,
    donate: bool = False,
) -> IvfPq:
    """Incrementally add vectors to an existing index (functional — the
    input index is untouched and a new :class:`IvfPq` is returned).

    New rows go to empty slots of their nearest coarse cell (then the
    next ``overflow_candidates`` cells with space, then — under the
    default ``on_overflow="spill"`` — the nearest cell anywhere with
    space; ``"error"``/``"drop"`` as in :func:`build_ivf`).  Slots freed
    by :func:`ivf_remove` are reused.  Quantizers are NOT retrained:
    after heavy distribution drift or when cells fill up
    (``ValueError: total free capacity``), rebuild with
    :func:`build_ivf` at a larger capacity.

    ``ids`` are the corpus rows the new vectors represent (defaults to
    ``max(existing ids) + 1 + arange(n_new)``; must be non-negative —
    ``-1`` marks empty slots); duplicates of live ids are rejected.

    The resident cell tensors never cross to the host: occupancy stats,
    id-clash checks, free-slot assignment, and the final scatter all run
    on device, so host traffic is O(n_new + C + touched_cells), not
    O(C·L·m).  By default the scatter is copy-on-write (one O(C·L·m)
    HBM-bandwidth copy; the input index stays valid).  ``donate=True``
    updates the buffers in place — zero-copy, but the donated buffers are
    consumed for EVERY index that shares them, not just the direct input:
    :func:`ivf_remove` returns an index whose ``cell_codes``/``cell_norms``
    alias its input's, so donating a post-remove index also invalidates
    the pre-remove index (and any other index in that alias chain); using
    them afterwards raises a deleted-buffer error.  The right mode for
    high-rate streaming updates where only the newest index is kept.
    """
    if _is_reader(instances):
        raise TypeError(
            "ivf_add takes a device/host array; for reader-scale corpora "
            "rebuild with build_ivf(reader)"
        )
    if on_overflow not in ("spill", "error", "drop"):
        raise ValueError(
            f'on_overflow must be "spill", "error", or "drop", '
            f"got {on_overflow!r}"
        )
    n_new, d = instances.shape
    coarse = index.coarse_centroids
    C, L = index.n_cells, index.capacity
    m = index.pq.quantized_len
    from .dispatch import use_kernel as choose

    use_kernel = choose("encode", use_kernel)
    dtype = index.cell_codes.dtype

    if ids is None:
        # max() over the resident tensor is a device reduce; -1 (all
        # slots empty) maps to start=0.
        start = max(int(jnp.max(index.cell_ids)) + 1, 0)
        ids = start + np.arange(n_new, dtype=np.int64)
        if ids[-1] >= 2 ** 31:
            raise ValueError(
                f"auto-assigned ids would exceed int32 (next id {start}, "
                f"{n_new} new rows); pass explicit ids"
            )
    else:
        ids = np.asarray(ids, dtype=np.int64)
        if ids.shape != (n_new,):
            raise ValueError(
                f"ids has shape {ids.shape}, expected ({n_new},)"
            )
        if ids.min(initial=0) < 0:
            raise ValueError("ids must be non-negative (-1 marks empty slots)")
        if ids.max(initial=0) >= 2 ** 31:
            # cell_ids is int32; silently wrapping a larger id would store
            # a negative (= "empty") or aliased id and corrupt the index.
            raise ValueError(
                f"ids must fit int32 (max allowed {2 ** 31 - 1}, "
                f"got {int(ids.max())})"
            )
        if len(np.unique(ids)) != n_new:
            raise ValueError("duplicate ids in the batch")
        clash_mask = np.asarray(
            jnp.isin(jnp.asarray(ids.astype(np.int32)),
                     index.cell_ids.ravel())
        )
        if clash_mask.any():
            first = np.sort(ids[clash_mask])[:5]
            raise ValueError(
                f"{int(clash_mask.sum())} ids already live in the index "
                f"(first: {first.tolist()}); ivf_remove them first"
            )

    b1 = max(8192, min(batch, (1 << 28) // max(1, C)))

    # Device fast path: when every new row fits an empty slot of its
    # NEAREST cell (the common streaming case), placement, slot
    # assignment, encode, and scatter all run on device — the only host
    # crossing is the one overflow scalar.  Falls back to the greedy/
    # spill path below otherwise.
    assign = jnp.concatenate([
        _coarse_topk(instances[off : off + b1], coarse, 1)[:, 0]
        for off in range(0, n_new, b1)
    ])
    overflow, slot_dev = _add_fast_gate(index.cell_ids, assign, L)
    if not bool(overflow):
        codes_parts, norms_parts = [], []
        for off in range(0, n_new, batch):
            b = min(batch, n_new - off)
            codes_b, norms_b = _residual_encode_batch(
                coarse, index.pq, instances[off : off + b],
                jax.lax.dynamic_slice(assign, (off,), (b,)),
                use_kernel, jnp.dtype(dtype),
            )
            codes_parts.append(codes_b)
            norms_parts.append(norms_b)
        codes_cat = jnp.concatenate(codes_parts, axis=0)
        if index.packed:
            from .ops.packing import pack_u4_codes

            codes_cat = pack_u4_codes(codes_cat)
        scatter = _scatter_updates_donated if donate else _scatter_updates
        cell_codes, cell_ids_new, cell_norms = scatter(
            index.cell_codes, index.cell_ids, index.cell_norms,
            assign.astype(jnp.int32), slot_dev, codes_cat,
            jnp.asarray(ids.astype(np.int32)),
            jnp.concatenate(norms_parts, axis=0),
        )
        logger.info("IVF add (device fast path): %d rows placed", n_new)
        out = IvfPq(
            coarse_centroids=coarse, pq=index.pq, cell_codes=cell_codes,
            cell_ids=cell_ids_new, cell_norms=cell_norms,
        )
        out.dropped_ids = getattr(index, "dropped_ids",
                                  np.empty(0, np.int64))
        return out
    del slot_dev, assign

    fill = np.asarray(jnp.sum(index.cell_ids >= 0, axis=1)).astype(np.int64)
    free_total = int(C * L - fill.sum())
    if free_total < n_new and on_overflow != "drop":
        raise ValueError(
            f"IVF add: total free capacity {free_total} < {n_new} new "
            f"rows; rebuild with build_ivf at a larger capacity"
        )

    def fetch_rows(rows: np.ndarray):
        return jnp.take(instances, rows.astype(np.int32), axis=0)

    A = min(overflow_candidates, C)
    tops = [
        _coarse_topk(instances[off : off + b1], coarse, A)
        for off in range(0, n_new, b1)
    ]
    cands = np.asarray(jnp.concatenate(tops, axis=0)).astype(np.int64)
    del tops

    cell_of, slot_of, fill = _greedy_place(cands, C, L, fill)
    overflowed = np.where(cell_of < 0)[0]
    dropped_ids = np.empty(0, np.int64)
    if len(overflowed):
        if on_overflow == "error":
            raise ValueError(
                f"IVF add: {len(overflowed)} rows fit none of their {A} "
                f"candidate cells at capacity {L}; raise capacity or use "
                f'on_overflow="spill"'
            )
        if on_overflow == "spill":
            _spill_place(overflowed, coarse, fetch_rows, C, L, fill,
                         cell_of, slot_of)
        else:  # "drop"
            dropped_ids = ids[overflowed]
            logger.warning(
                "IVF add: %d rows dropped (ids on index.dropped_ids)",
                len(overflowed),
            )

    slot_of = _assign_free_slots(cell_of, slot_of, index.cell_ids)

    placed_rows = np.where(cell_of >= 0)[0]
    codes_parts, norms_parts = [], []
    for off in range(0, len(placed_rows), batch):
        rows = placed_rows[off : off + batch]
        codes_b, norms_b = _residual_encode_batch(
            coarse, index.pq, fetch_rows(rows),
            jnp.asarray(cell_of[rows].astype(np.int32)),
            use_kernel, jnp.dtype(dtype),
        )
        codes_parts.append(codes_b)
        norms_parts.append(norms_b)
    if len(placed_rows):
        codes_cat = jnp.concatenate(codes_parts, axis=0)
        if index.packed:
            from .ops.packing import pack_u4_codes

            codes_cat = pack_u4_codes(codes_cat)
        scatter = _scatter_updates_donated if donate else _scatter_updates
        cell_codes, cell_ids_new, cell_norms = scatter(
            index.cell_codes, index.cell_ids, index.cell_norms,
            jnp.asarray(cell_of[placed_rows].astype(np.int32)),
            jnp.asarray(slot_of[placed_rows].astype(np.int32)),
            codes_cat,
            jnp.asarray(ids[placed_rows].astype(np.int32)),
            jnp.concatenate(norms_parts, axis=0),
        )
    else:
        cell_codes = index.cell_codes
        cell_ids_new = index.cell_ids
        cell_norms = index.cell_norms

    logger.info("IVF add: %d rows placed (%d dropped)",
                len(placed_rows), len(dropped_ids))
    out = IvfPq(
        coarse_centroids=coarse,
        pq=index.pq,
        cell_codes=cell_codes,
        cell_ids=cell_ids_new,
        cell_norms=cell_norms,
    )
    # Accumulate with the input index's record (a build under
    # on_overflow="drop" stores its dropped rows there; losing it on the
    # next add would break the artifact's build-metadata contract).
    out.dropped_ids = np.concatenate([
        getattr(index, "dropped_ids", np.empty(0, np.int64)), dropped_ids
    ])
    return out


def ivf_remove(index: IvfPq, ids) -> IvfPq:
    """Remove vectors by corpus id (functional — returns a new index).

    Matching slots become empty (``id=-1``, masked at score time) and
    are reused by subsequent :func:`ivf_add` calls; cell tensors keep
    their static shapes, so compiled search programs are unaffected.
    Ids not present in the index are ignored (removal is idempotent);
    ids outside the int32 range cannot be present and are likewise
    ignored.  The membership test and mask run on device — host traffic
    is O(len(ids)), not O(C·L).

    The returned index's ``cell_codes``/``cell_norms`` ALIAS the input's
    buffers (only ``cell_ids`` is new) — a later ``ivf_add(...,
    donate=True)`` on either index therefore consumes the buffers of
    both; see :func:`ivf_add`.
    """
    ids = np.unique(np.asarray(ids, dtype=np.int64).ravel())
    # cell_ids is int32, so ids outside [0, 2^31) cannot be present —
    # drop them BEFORE the int32 cast (a wrapped id would alias a live
    # row), preserving ignore-missing semantics.
    ids = ids[(ids >= 0) & (ids < 2 ** 31)]
    kill = jnp.isin(index.cell_ids,
                    jnp.asarray(ids.astype(np.int32)))
    kill = kill & (index.cell_ids >= 0)
    cell_ids_new = jnp.where(kill, -1, index.cell_ids)
    if logger.isEnabledFor(logging.INFO):  # int() forces a device sync
        logger.info("IVF remove: %d of %d requested ids removed",
                    int(jnp.sum(kill)), len(ids))
    out = IvfPq(
        coarse_centroids=index.coarse_centroids,
        pq=index.pq,
        cell_codes=index.cell_codes,
        cell_ids=cell_ids_new,
        cell_norms=index.cell_norms,
    )
    out.dropped_ids = getattr(index, "dropped_ids", np.empty(0, np.int64))
    return out

# Bytes of transient (nq, probes, L, d) f32 reconstruction a single
# scoring dispatch may materialize; _probe_and_score chunks over probes
# (and over cell rows when one probe alone exceeds it, e.g. L ~ 50k at
# d=768).  A cap on transients, not a rate: it keeps a probe batch to a
# small share of any card's memory.  Module-level so tests can shrink it
# to exercise the chunked paths at toy sizes.
_PROBE_RECON_BUDGET = 1 << 30

# Bytes of transient (nq, cells_per_chunk * L) f32 scores one LUT-path
# scoring chunk may materialize (a cap, like the one above).
# Module-level so tests can shrink it to exercise the multi-chunk union
# scan at toy sizes.
_PROBE_LUT_BUDGET = 1 << 28


def _probe_and_score_lut(
    queries: Array,
    coarse: Array,
    cell_codes: Array,
    cell_ids: Array,
    cell_norms: Array,
    pq: Pq,
    nprobe: int,
    top_k: int,
    metric: str = "l2",
    valid: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """Union-of-cells LUT (ADC) probe scoring: returns the final
    ``(dists, ids)`` of shape ``(nq, top_k)`` directly.

    The decode path (:func:`_probe_and_score`) reconstructs every
    gathered candidate to ``d`` floats — ``nq * nprobe * L * d * 4``
    bytes of transients, tens of GB at d=768/L=8000/nq=128.  Classic
    IVFADC replaces the decode with per-query lookup tables (Jégou et
    al., 2011, Eq. 13): ``q.rec = sum_j T[q, j, code_j]``, scored by
    :func:`reductive_tpu.ops.adc.adc_scores_kernel`.  That kernel scores
    a block of code rows against *all* queries, so the **union** of
    probed cells is scored once against every query (queries probing
    the same cell share its rows — a mini exhaustive scan over the
    ``<= min(nq * nprobe, C)`` distinct probed cells), and each query
    masks cells it did not probe before a running top-k merge.  Work is
    ``U * L`` rows instead of the decode path's ``nq * nprobe * L`` —
    *fewer* scored rows whenever probe sets overlap.

    The union is built scatter-free (sort + neighbor-dedup + ``top_k``
    compaction to the static ``U`` cap) and scanned in cell chunks whose
    ``(nq, cells * L)`` score transient stays under
    ``_PROBE_LUT_BUDGET``.  ``valid`` (``(C,)`` bool) excludes cells from
    probe selection, as in :func:`_probe_and_score`.
    """
    from .ops import adc
    from .search import adc_tables

    C, L, mb = cell_codes.shape
    m = pq.quantized_len
    nq = queries.shape[0]

    qc = jnp.dot(queries, coarse.T, precision="highest")  # (nq, C)
    if metric == "dot":
        score_c = qc
        q_sqn = None
    else:
        q_sqn = jnp.sum(queries * queries, axis=1)  # (nq,)
        c_sqn = jnp.sum(coarse * coarse, axis=1)
        score_c = -(q_sqn[:, None] + c_sqn[None, :] - 2.0 * qc)
    if valid is not None:
        score_c = jnp.where(valid[None, :], score_c, -jnp.inf)
    _, probe = jax.lax.top_k(score_c, nprobe)  # (nq, np)

    # Distinct probed cells, compacted to the static cap U (ascending;
    # pads hold C + 1, which never equals a probe and clips for gathers).
    U = min(nq * nprobe, C)
    p = jnp.sort(probe.reshape(-1))
    first = jnp.concatenate(
        [jnp.ones((1,), bool), p[1:] != p[:-1]]
    )
    neg, _ = jax.lax.top_k(
        jnp.where(first, -p, -jnp.int32(C) - 1), U
    )
    cells_u = -neg  # unique ascending, then C + 1 padding

    # -<q, rec> tables in the residual PQ's (possibly rotated) space;
    # the orthonormal projection preserves inner products.
    tables = adc_tables(pq, queries, metric="dot")  # (nq, m, k)

    cc = max(1, min(U, _PROBE_LUT_BUDGET // (4 * max(nq, 1) * L)))
    rounds = -(-U // cc)
    pad = rounds * cc - U
    cells_sc = jnp.concatenate(
        [cells_u, jnp.full((pad,), C + 1, cells_u.dtype)]
    ).reshape(rounds, cc)
    K = min(top_k, U * L)
    packed = mb != m

    def body(carry, cu):
        best_negd, best_idx = carry
        cuc = jnp.clip(cu, 0, C - 1)
        codes_c = jnp.take(cell_codes, cuc, axis=0).reshape(cc * L, mb)
        ids_c = jnp.take(cell_ids, cuc, axis=0).reshape(cc * L)
        norms_c = jnp.take(cell_norms, cuc, axis=0).reshape(cc * L)
        raw = adc.adc_scores_kernel(
            tables, codes_c, packed=packed
        )  # (nq, cc*L) = -<q, rec>
        qc_c = jnp.take(qc, cuc, axis=1)  # (nq, cc)
        if metric == "dot":
            sc = raw.reshape(nq, cc, L) - qc_c[:, :, None]
        else:
            sc = (
                q_sqn[:, None, None]
                + norms_c.reshape(1, cc, L)
                + 2.0 * raw.reshape(nq, cc, L)
                - 2.0 * qc_c[:, :, None]
            )
        # Padded cells (cu == C + 1) never match a probe, so the probed
        # mask silences them along with cells this query did not ask for.
        probed = jnp.any(
            probe[:, :, None] == cu[None, None, :], axis=1
        )  # (nq, cc)
        mask = probed[:, :, None] & (ids_c.reshape(1, cc, L) >= 0)
        sc = jnp.where(mask, sc, jnp.inf).reshape(nq, cc * L)
        negd, pos = jax.lax.top_k(-sc, min(K, cc * L))
        idx = jnp.take(ids_c, pos)  # (nq, K) gather of shared flat ids
        cat_negd = jnp.concatenate([best_negd, negd], axis=1)
        cat_idx = jnp.concatenate([best_idx, idx], axis=1)
        new_negd, sel = jax.lax.top_k(cat_negd, K)
        new_idx = jnp.take_along_axis(cat_idx, sel, axis=1)
        return (new_negd, new_idx), None

    # Score dtype follows the inputs (f64 queries under x64 keep f64
    # coarse terms around the kernel's f32 table sums).
    st = jnp.result_type(queries.dtype, coarse.dtype, jnp.float32)
    init = (
        jnp.full((nq, K), -jnp.inf, st),
        jnp.full((nq, K), -1, cell_ids.dtype),
    )
    (best_negd, best_idx), _ = jax.lax.scan(body, init, cells_sc)
    dists = -best_negd
    ids = jnp.where(jnp.isfinite(dists), best_idx, -1)
    if K < top_k:
        padk = top_k - K
        dists = jnp.concatenate(
            [dists, jnp.full((nq, padk), jnp.inf, dists.dtype)], axis=1
        )
        ids = jnp.concatenate(
            [ids, jnp.full((nq, padk), -1, ids.dtype)], axis=1
        )
    return dists, ids


def _probe_and_score(
    queries: Array,
    coarse: Array,
    cell_codes: Array,
    cell_ids: Array,
    cell_norms: Array,
    pq: Pq,
    nprobe: int,
    metric: str = "l2",
    valid: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """Score the top-``nprobe`` cells of the given coarse block for every
    query; returns flattened ``(scores, ids)`` of shape
    ``(nq, nprobe * L)`` (empty slots at ``+inf`` / ``-1``).  The shared
    core of the single-device and sharded searches — in the sharded case
    ``coarse``/``cell_*`` are one device's shard and ``cell_ids`` carry
    global corpus rows.

    ``metric="dot"`` probes the cells with the **largest** query·centroid
    inner product and scores by the exact same IVFADC decomposition for
    inner products, ``<q, c + rec> = q.c + q.rec`` (scores are negated so
    ascending order still means best-first); cell norms are unused.

    ``valid`` (optional, ``(C,)`` bool) excludes cells from probe
    selection — used by the sharded search to mask the all-empty cells
    appended for even sharding so they never displace a real probe."""
    cb = pq.codebooks
    m, k, ds = cb.shape
    d = m * ds
    nq = queries.shape[0]
    L = cell_codes.shape[1]
    mb = cell_codes.shape[2]  # m/2 when nibble-packed (IvfPq.packed)

    # Nearest coarse cells — one matmul feeding both the probe selection
    # and the q.c terms (for scoring).
    qc = jnp.dot(queries, coarse.T, precision="highest")      # (nq, C)
    if metric == "dot":
        score_c = qc
    else:
        q_sqn = jnp.sum(queries * queries, axis=1)            # (nq,)
        c_sqn = jnp.sum(coarse * coarse, axis=1)              # (C,)
        score_c = -(q_sqn[:, None] + c_sqn[None, :] - 2.0 * qc)
    if valid is not None:
        score_c = jnp.where(valid[None, :], score_c, -jnp.inf)
    _, probe = jax.lax.top_k(score_c, nprobe)                 # (nq, np)
    qc_g = jnp.take_along_axis(qc, probe, axis=1)             # (nq, np)

    # Gather the probed cells (contiguous row blocks — cheap).
    codes_g = jnp.take(cell_codes, probe, axis=0)             # (nq, np, L, m)
    ids_g = jnp.take(cell_ids, probe, axis=0)                 # (nq, np, L)
    norms_g = jnp.take(cell_norms, probe, axis=0)             # (nq, np, L)

    # q.rec via a gather-decode + one batched dot; the reconstruction
    # lives in the residual PQ's (possibly rotated) space.  Probes are
    # processed in chunks so the transient (nq, chunk, L, d) f32
    # reconstruction stays under ~1 GB regardless of (nq, nprobe, L) —
    # at 100M-scale indexes (L in the tens of thousands) the unchunked
    # buffer would exceed HBM for even small query batches.
    qr = (
        jnp.dot(queries, pq.projection, precision="highest")
        if pq.projection is not None
        else queries
    )

    def qdot(codes_chunk):  # (nq, pc, lc, mb) -> (nq, pc, lc)
        pc, lc = codes_chunk.shape[1], codes_chunk.shape[2]
        flat = codes_chunk.reshape(nq * pc * lc, mb)
        if mb != m:
            # Packed cells: the gather above moved half the bytes; the
            # nibble unpack here is exact, so scores are bit-equal to
            # the unpacked index's.
            from .ops.packing import unpack_u4_codes

            flat = unpack_u4_codes(flat)
        from .pq import primitives

        rec = primitives.reconstruct_batch(cb, flat).reshape(nq, pc * lc, d)
        # Multiply and reduce over d elementwise: the same f32 terms in
        # the same order whatever the chunking (a batched matmul may
        # reorder its sums with the chunk shape).
        dots = jnp.sum(rec.astype(jnp.float32) * qr.astype(jnp.float32)[:, None, :],
                       axis=-1)
        return dots.reshape(nq, pc, lc)

    budget = _PROBE_RECON_BUDGET  # bytes of transient reconstruction
    pc = max(1, min(nprobe, budget // max(1, nq * L * d * 4)))
    if nq * L * d * 4 <= budget:
        dot = jnp.concatenate(
            [qdot(codes_g[:, p0 : p0 + pc]) for p0 in range(0, nprobe, pc)],
            axis=1,
        )
    else:
        # Even a single probe's (nq, L, d) reconstruction exceeds the
        # budget (large-capacity cells, e.g. L = 8000 at d=768 with 128
        # queries): chunk the cell rows too, and run the probes through
        # ``lax.map`` so the program holds ONE probe's body instead of
        # nprobe unrolled copies (an unrolled nprobe=64 xL-chunks build
        # measured 19.8 GB of HLO temps — over HBM by itself).
        lc = max(1, budget // max(1, nq * d * 4))

        def one_probe(codes_p):  # (nq, L, mb) -> (nq, L)
            return jnp.concatenate(
                [
                    qdot(codes_p[:, None, l0 : l0 + lc])
                    for l0 in range(0, L, lc)
                ],
                axis=2,
            )[:, 0]

        dot = jnp.moveaxis(
            jax.lax.map(one_probe, jnp.moveaxis(codes_g, 1, 0)), 0, 1
        )

    if metric == "dot":
        scores = -(qc_g[:, :, None] + dot)
    else:
        scores = (
            q_sqn[:, None, None] + norms_g - 2.0 * qc_g[:, :, None] - 2.0 * dot
        )
    scores = jnp.where(ids_g >= 0, scores, jnp.inf)  # mask empty slots
    return scores.reshape(nq, -1), ids_g.reshape(nq, -1)


def _padded_topk(
    flat_scores: Array, flat_ids: Array, top_k: int
) -> Tuple[Array, Array]:
    """Top-``top_k`` by ascending score, padded with ``+inf`` / ``-1``
    when fewer candidates exist."""
    nq = flat_scores.shape[0]
    kk = min(top_k, flat_scores.shape[1])
    neg, sel = jax.lax.top_k(-flat_scores, kk)
    dists = -neg
    ids = jnp.take_along_axis(flat_ids, sel, axis=1)
    if kk < top_k:
        pad = top_k - kk
        dists = jnp.concatenate(
            [dists, jnp.full((nq, pad), jnp.inf, dists.dtype)], axis=1
        )
        ids = jnp.concatenate([ids, jnp.full((nq, pad), -1, ids.dtype)], axis=1)
    return dists, ids


def _probe_topk(
    queries, coarse, cell_codes, cell_ids, cell_norms, pq, nprobe: int,
    top_k: int, use_kernel: bool, metric: str, valid=None,
) -> Tuple[Array, Array]:
    """``(nq, top_k)`` best candidates of the probed cells: the LUT path
    with the ADC kernel, or the gather-decode path."""
    if use_kernel:
        return _probe_and_score_lut(
            queries, coarse, cell_codes, cell_ids, cell_norms, pq, nprobe,
            top_k, metric, valid=valid,
        )
    flat_scores, flat_ids = _probe_and_score(
        queries, coarse, cell_codes, cell_ids, cell_norms, pq, nprobe,
        metric, valid=valid,
    )
    return _padded_topk(flat_scores, flat_ids, top_k)


@functools.partial(
    jax.jit, static_argnames=("top_k", "nprobe", "use_kernel", "metric"),
)
def _ivf_search_jit(
    index: IvfPq, queries: Array, top_k: int, nprobe: int,
    use_kernel: bool, metric: str = "l2",
) -> Tuple[Array, Array]:
    return _probe_topk(
        queries, index.coarse_centroids, index.cell_codes, index.cell_ids,
        index.cell_norms, index.pq, nprobe, top_k, use_kernel, metric,
    )


def _resolve_probe_kernel(index: IvfPq, use_kernel: Optional[bool]) -> bool:
    from .dispatch import use_kernel as choose

    return choose("adc", use_kernel, codes_dtype=index.cell_codes.dtype,
                  packed=index.packed)


def ivf_search(
    index: IvfPq,
    queries: Array,
    top_k: int = 10,
    *,
    nprobe: int = 8,
    use_kernel: Optional[bool] = None,
    refine_with: Optional[Array] = None,
    refine_factor: int = 4,
    metric: str = "l2",
) -> Tuple[Array, Array]:
    """Top-``top_k`` approximate neighbors per query, scanning only the
    ``nprobe`` nearest coarse cells.

    Returns ``(distances, ids)`` of shape ``(nq, top_k)``: approximate
    squared distances and original corpus rows.  Fewer than ``top_k``
    hits in the probed cells pads with ``id=-1`` / ``distance=+inf``.

    Scoring uses the IVFADC decomposition (Jégou et al., 2011, Eq. 13)
    ``||q - c - rec||^2 = ||q||^2 + g - 2 q.c - 2 q.rec`` with ``g``
    precomputed at build time: one coarse matmul, then ``q.rec`` either
    from per-query lookup tables scored by the GPU ADC kernel over the
    union of probed cells, or (plain path) from a gather-decode of the
    probed candidates and one batched dot.  The scanned fraction is
    ``nprobe / C`` of the corpus.  ``use_kernel`` is resolved by
    :func:`reductive_tpu.dispatch.use_kernel`; both paths sum the same
    f32 terms, so they agree up to f32 summation order.

    ``refine_with`` (the original ``(n, d)`` vectors, device-resident —
    or a ``VecsReader``-like object for corpora larger than HBM)
    adds the exact refine stage: ``top_k * refine_factor`` IVF candidates
    are re-scored with true squared distances and the best ``top_k``
    returned (same contract as :func:`reductive_tpu.search.search`).

    ``metric="dot"`` searches by **maximum inner product** instead
    (FAISS ``METRIC_INNER_PRODUCT`` analog): cells are still Euclidean
    k-means partitions, probed by largest query·centroid product, and
    candidates score by the exact IP decomposition
    ``<q, c + rec> = q.c + q.rec``.  Returned "distances" are negated
    inner products (ascending = best).  Caveat inherent to IVF-IP:
    high-norm corpus vectors in far cells can be missed — raise
    ``nprobe`` (or use exhaustive ``search(metric="dot")``) when the
    norm distribution is heavy-tailed.  Cosine = dot on pre-normalized
    corpus/queries, where this caveat vanishes.
    """
    if metric not in ("l2", "dot"):
        raise ValueError(f"unknown metric {metric!r} (expected 'l2' or 'dot')")
    use_kernel = _resolve_probe_kernel(index, use_kernel)
    if refine_with is not None:
        from .search import _refine_jit

        if refine_factor < 1:
            raise ValueError("refine_factor must be >= 1")
        r = top_k * refine_factor
        _, cand = _ivf_search_jit(
            index, queries, r, nprobe, use_kernel, metric
        )
        return _refine_jit(queries, refine_with, cand, top_k, metric)
    return _ivf_search_jit(index, queries, top_k, nprobe, use_kernel, metric)


def ivf_search_sharded(
    index: IvfPq,
    queries: Array,
    top_k: int = 10,
    *,
    nprobe: int = 8,
    mesh,
    cell_axis: str = "data",
    use_kernel: Optional[bool] = None,
    metric: str = "l2",
) -> Tuple[Array, Array]:
    """Multi-device IVF search: cells sharded over ``cell_axis``, queries
    replicated, per-device local top-k merged by an all-gather.

    Each device probes the ``nprobe`` nearest of *its own* cell shard.
    Any cell in the global top-``nprobe`` is necessarily in its owner's
    local top-``nprobe`` (fewer than ``nprobe`` cells beat it anywhere),
    so the union of locally probed cells is a **superset** of the
    single-device probes (for ``metric="dot"`` the identical argument
    holds with "nearest" read as largest inner product) — result quality
    is at least that of
    :func:`ivf_search` with the same ``nprobe``, per-device work is one
    ``nprobe``-cell scan, and the only communication is the final
    ``(nq, top_k)`` merge (tiny).  A cell count that does not divide the
    axis size is padded with empty cells (ids ``-1``) up to the next
    multiple; the pads are excluded from probe selection, so results
    still equal single-device :func:`ivf_search`.  ``cell_ids`` hold
    global corpus rows, so merged ids are directly usable.
    """
    if metric not in ("l2", "dot"):
        raise ValueError(f"unknown metric {metric!r} (expected 'l2' or 'dot')")
    use_kernel = _resolve_probe_kernel(index, use_kernel)
    from jax.sharding import NamedSharding, PartitionSpec as P

    C = index.n_cells
    n_shards = mesh.shape[cell_axis]
    coarse_a, codes_a = index.coarse_centroids, index.cell_codes
    ids_a, norms_a = index.cell_ids, index.cell_norms
    C_true = None
    if C % n_shards != 0:
        pad = n_shards - C % n_shards
        coarse_a = jnp.concatenate(
            [coarse_a, jnp.zeros((pad, coarse_a.shape[1]), coarse_a.dtype)]
        )
        codes_a = jnp.concatenate(
            [codes_a, jnp.zeros((pad,) + codes_a.shape[1:], codes_a.dtype)]
        )
        ids_a = jnp.concatenate(
            [ids_a, jnp.full((pad, ids_a.shape[1]), -1, ids_a.dtype)]
        )
        norms_a = jnp.concatenate(
            [norms_a, jnp.zeros((pad, norms_a.shape[1]), norms_a.dtype)]
        )
        C_true = C
        C = C + pad
    if nprobe > C // n_shards:
        raise ValueError(
            f"nprobe={nprobe} exceeds the per-shard cell count "
            f"{C // n_shards}"
        )

    # device_put is a no-op for arrays already laid out with the target
    # sharding, so repeated calls on a resident index only move data the
    # first time; the compiled program is cached per (mesh, config).
    coarse = jax.device_put(coarse_a, NamedSharding(mesh, P(cell_axis, None)))
    codes = jax.device_put(codes_a, NamedSharding(mesh, P(cell_axis, None, None)))
    ids = jax.device_put(ids_a, NamedSharding(mesh, P(cell_axis, None)))
    norms = jax.device_put(norms_a, NamedSharding(mesh, P(cell_axis, None)))
    valid = jax.device_put(
        jnp.arange(C, dtype=jnp.int32) < (C if C_true is None else C_true),
        NamedSharding(mesh, P(cell_axis)),
    )
    run = _ivf_sharded_fn(mesh, cell_axis, nprobe, top_k, use_kernel, metric)
    return run(queries, coarse, codes, ids, norms, valid, index.pq)


@functools.lru_cache(maxsize=None)
def _ivf_sharded_fn(mesh, cell_axis: str, nprobe: int, top_k: int,
                    use_kernel: bool, metric: str = "l2"):
    """Build (and cache) the jitted sharded IVF search for a mesh/config —
    a fresh closure per call would re-trace and re-compile every time."""
    from jax.sharding import PartitionSpec as P

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(cell_axis, None), P(cell_axis, None, None),
            P(cell_axis, None), P(cell_axis, None), P(cell_axis), P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(q, coarse_l, codes_l, ids_l, norms_l, valid_l, pq):
        d_loc, i_loc = _probe_topk(
            q, coarse_l, codes_l, ids_l, norms_l, pq, nprobe, top_k,
            use_kernel, metric, valid=valid_l,
        )
        # Merge: gather every device's local top-k and reselect.
        d_all = jax.lax.all_gather(d_loc, cell_axis)  # (ndev, nq, top_k)
        i_all = jax.lax.all_gather(i_loc, cell_axis)
        nq = q.shape[0]
        d_flat = jnp.moveaxis(d_all, 0, 1).reshape(nq, -1)
        i_flat = jnp.moveaxis(i_all, 0, 1).reshape(nq, -1)
        return _padded_topk(d_flat, i_flat, top_k)

    return run

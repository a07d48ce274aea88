"""Plain product-quantizer training: batched k-means over the subquantizer axis.

Counterpart of the reference's ``TrainPq for Pq``
(reference: ``src/pq/pq.rs:196-250``).  The reference fans the ``m``
independent subquantizer k-means trainings out over a rayon thread pool
(``src/pq/pq.rs:226-241``) and repeats each one ``n_attempts`` times,
keeping the minimum-loss attempt (``src/pq/pq.rs:168-188``).  Here both the
``m`` axis and the attempts axis are **batch axes of one jitted tensor
program**: a double-``vmap`` over ``(n_attempts, m)`` runs every k-means
simultaneously as a single ``(n_attempts, m, k, ds)`` computation — no host
threads, no retracing across attempts, and the device sees large batched
matmuls instead of ``m`` small sequential ones.

RNG discipline: the reference seeds one XorShift stream per subquantizer
from a master ChaCha8 RNG (``src/pq/pq.rs:221-224``); here each
``(attempt, subquantizer)`` pair gets an independent fold of the caller's
PRNG key — the counter-based JAX equivalent of uncorrelated streams.
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import Array

logger = logging.getLogger("reductive_tpu")

from ..errors import check_quantizer_invariants
from ..kmeans import (
    NIterations,
    kmeans_with_centroids,
    random_distinct_indices,
)
from .model import Pq

__all__ = [
    "train_pq",
    "train_pq_chunked",
    "train_pq_subspace",
    "train_pq_subspace_with_centroids",
    "assign_stats_streamed",
    "lloyd_iteration_chunked",
    "init_codebooks_random",
]


def init_codebooks_random(
    x: Array, keys: Array, k: int, ds: int, projection: Optional[Array] = None
) -> Array:
    """``(m, k, ds)`` initial codebooks: ``k`` distinct random instances per
    subquantizer, column-sliced — and rotated on the fly (rows only) when a
    ``projection`` is given, so the rotated corpus is never materialized.

    The shared initial-codebook draw of the chunked, OPQ, and sharded
    trainers (reference: ``RandomInstanceCentroids``, ``src/kmeans.rs:52-87``,
    applied per subquantizer slice as in ``src/pq/pq.rs:117-136`` /
    ``src/pq/opq.rs:138-159``).  ``keys`` is ``(m, 2)`` — one PRNG key per
    subquantizer; trace-safe (callable inside jit / shard_map).
    """
    n = x.shape[0]

    def init_one(key, j):
        idx = random_distinct_indices(key, n, k)
        rows = jnp.take(x, idx, axis=0)
        if projection is not None:
            rows = jnp.dot(rows, projection, precision="highest")
        return jax.lax.dynamic_slice(rows, (0, j * ds), (k, ds))

    return jax.vmap(init_one)(keys, jnp.arange(keys.shape[0]))


def _subquantizer_initial_centroids(key: Array, xs: Array, k: int) -> Array:
    """Initial centroids for one subquantizer: ``k`` distinct random
    instances of the ``(n, ds)`` subvector slice (reference:
    ``subquantizer_initial_centroids``, ``src/pq/pq.rs:117-136`` →
    ``RandomInstanceCentroids``, ``src/kmeans.rs:52-87``)."""
    n = xs.shape[0]
    indices = jax.random.choice(key, n, shape=(k,), replace=False)
    return jnp.take(xs, indices, axis=0)


@partial(jax.jit, static_argnames=("k", "n_attempts"))
def _train_codebooks(
    key: Array, xs: Array, k: int, n_iterations, n_attempts: int
) -> tuple[Array, Array]:
    """Train all ``m`` subquantizers, ``n_attempts`` times each, in one
    compiled program.

    ``xs`` is the instance tensor reshaped to ``(n, m, ds)``.  Returns the
    best-of-attempts ``(m, k, ds)`` codebooks and the per-subquantizer
    losses ``(m,)``.  ``n_iterations`` is a runtime value, so one
    compilation per ``(shape, k, n_attempts)`` serves every iteration
    count.
    """
    n, m, ds = xs.shape
    xs_m = jnp.moveaxis(xs, 1, 0)  # (m, n, ds)
    keys = jax.random.split(key, n_attempts * m).reshape(n_attempts, m, 2)

    def one(key, x_sq):
        centroids = _subquantizer_initial_centroids(key, x_sq, k)
        return kmeans_with_centroids(x_sq, centroids, NIterations(n_iterations))

    # vmap over subquantizers, then over attempts: (a, m, k, ds), (a, m)
    codebooks, losses = jax.vmap(jax.vmap(one, in_axes=(0, 0)), in_axes=(0, None))(
        keys, xs_m
    )
    return _best_of_attempts(codebooks, losses)


def _best_of_attempts(codebooks: Array, losses: Array) -> tuple[Array, Array]:
    """Keep the minimum-loss attempt per subquantizer; argmin ties break to
    the first attempt, matching the reference's min_by_key scan
    (src/pq/pq.rs:183-187).  ``codebooks`` is ``(a, m, k, ds)``, ``losses``
    ``(a, m)``."""
    best = jnp.argmin(losses, axis=0)  # (m,)
    best_codebooks = jnp.take_along_axis(
        codebooks, best[None, :, None, None], axis=0
    )[0]
    best_losses = jnp.take_along_axis(losses, best[None, :], axis=0)[0]
    return best_codebooks, best_losses


@jax.jit
def train_pq_subspace_with_centroids(
    xs: Array, initial: Array, n_iterations
) -> tuple[Array, Array]:
    """Train all subquantizers from explicitly supplied initial centroids.

    ``xs`` is ``(n, m, ds)`` instance data; ``initial`` is
    ``(n_attempts, m, k, ds)`` initial centroids — one full set per
    (attempt, subquantizer).  Runs the same double-vmapped Lloyd's program
    as :func:`train_pq` and keeps the best attempt per subquantizer.  This
    is the entry the conformance mode uses after replicating the
    reference's centroid draws on the host
    (``reductive_tpu.conformance``)."""
    xs_m = jnp.moveaxis(xs, 1, 0)  # (m, n, ds)

    def one(centroids, x_sq):
        return kmeans_with_centroids(x_sq, centroids, NIterations(n_iterations))

    codebooks, losses = jax.vmap(jax.vmap(one, in_axes=(0, 0)), in_axes=(0, None))(
        initial, xs_m
    )
    return _best_of_attempts(codebooks, losses)


def train_pq(
    key: Array,
    instances: Array,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
) -> Pq:
    """Train a plain product quantizer (reference: ``TrainPq::train_pq_using``,
    ``src/pq/pq.rs:201-250``).

    Each of the ``n_subquantizers`` subquantizers gets ``2**n_subquantizer_bits``
    centroids, trained with ``n_iterations`` Lloyd's iterations; each is
    trained ``n_attempts`` times and the minimum-loss attempt is kept.
    Raises a :class:`~reductive_tpu.errors.ReductiveError` subclass on
    invalid hyperparameters.
    """
    n, d = instances.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    k = 2 ** n_subquantizer_bits
    ds = d // n_subquantizers
    # Phase marker mirroring the reference's per-subquantizer log
    # (src/pq/pq.rs:159) — here all m train at once in one program.
    logger.info(
        "Training %d PQ subquantizers (k=%d, %d iterations, %d attempts)",
        n_subquantizers, k, n_iterations, n_attempts,
    )
    xs = instances.reshape(n, n_subquantizers, ds)
    codebooks, losses = _train_codebooks(key, xs, k, n_iterations, n_attempts)
    if logger.isEnabledFor(logging.INFO):
        logger.info(
            "Per-subquantizer losses: %s",
            [round(float(l), 6) for l in losses],
        )
    return Pq(codebooks=codebooks, projection=None)


def train_pq_subspace(
    key: Array, xs: Array, k: int, n_iterations: int, n_attempts: int
) -> tuple[Array, Array]:
    """Lower-level entry returning raw ``(m, k, ds)`` codebooks and per-
    subquantizer losses for pre-reshaped ``(n, m, ds)`` data.  Used by the
    OPQ trainers, which manage projection and validation themselves."""
    return _train_codebooks(key, xs, k, n_iterations, n_attempts)


# ---------------------------------------------------------------------------
# Chunked (large-n) training
# ---------------------------------------------------------------------------
#
# The in-memory Lloyd's step materializes the (m, n, k) distance tensor —
# 16 GB at the flagship shape with n = 1M.  The chunked step streams over
# n instead: per chunk, an assignment (the GPU encode kernel never writes
# the distances) plus sorted-segment-sum sufficient statistics
# (per-centroid sums S and counts c).  The
# reference's loss — MSE between instances and their *updated* centroids
# under the old assignments (src/kmeans.rs:319-327) — never needs a second
# pass over the data: with c'_j = S_j / n_j,
#
#     sse = sum_i ||x_i - c'_{a_i}||^2
#         = sum_i ||x_i||^2 - 2 sum_j c'_j . S_j + sum_j n_j ||c'_j||^2
#         = sumsq - sum_{j nonempty} ||S_j||^2 / n_j
#
# so one pass yields assignment, update, and loss.  Empty clusters become
# the zero vector and contribute zero sse, exactly the reference's
# semantics (src/kmeans.rs:181,194-196).


def sorted_segment_sum(values: Array, segment: Array, num_segments: int
                       ) -> tuple[Array, Array]:
    """Sums ``(num_segments, w)`` of the ``(N, w)`` ``values`` rows in each
    segment, and the int32 row count of each segment, with a summation
    order fixed by the data alone.

    A float scatter-add (``jax.ops.segment_sum``) lowers to atomics on a
    GPU, so its bits change from run to run.  Here the rows are sorted by
    segment (stable), summed by a segmented prefix scan, and each sum is
    read at its segment's last row; the counts are an integer bincount,
    exact in any order.  Empty segments sum to zero."""
    order = jnp.argsort(segment, stable=True)
    seg = segment[order]
    start = jnp.concatenate([jnp.ones((1,), bool), seg[1:] != seg[:-1]])

    def combine(a, b):
        a_start, a_sum = a
        b_start, b_sum = b
        return a_start | b_start, jnp.where(b_start[:, None], b_sum, a_sum + b_sum)

    _, running = jax.lax.associative_scan(combine, (start, values[order]))
    counts = jnp.bincount(segment, length=num_segments).astype(jnp.int32)
    last = jnp.maximum(jnp.cumsum(counts) - 1, 0)
    sums = jnp.where((counts > 0)[:, None], running[last], 0)
    return sums, counts


def _chunk_stats(codebooks: Array, xc: Array, use_kernel: bool) -> tuple[Array, Array]:
    """Per-centroid f32 instance sums ``(m, k, ds)`` and counts ``(m, k)``
    for one ``(c, d)`` chunk: codes from the encode kernel or the einsum
    (:func:`reductive_tpu.dispatch.encode`), then a
    :func:`sorted_segment_sum` of each subvector into its
    ``(subquantizer, centroid)`` segment — bit-reproducible run to run."""
    from ..dispatch import encode

    m, k, ds = codebooks.shape
    c = xc.shape[0]
    codes = encode(codebooks, xc, dtype=jnp.int32, use_kernel=use_kernel)
    xs = xc.reshape(c * m, ds).astype(jnp.float32)
    segment = codes + jnp.arange(m, dtype=jnp.int32)[None, :] * k
    sums, counts = sorted_segment_sum(xs, segment.reshape(-1), m * k)
    return sums.reshape(m, k, ds), counts.reshape(m, k).astype(jnp.float32)


def centroids_from_stats(sums: Array, counts: Array, dtype) -> Array:
    """Count-guarded centroid update from (sums, counts) statistics; empty
    clusters become the zero vector (reference semantics:
    ``src/kmeans.rs:181,194-196``).  Shared by the chunked, sharded, and
    OPQ trainers so the reference-critical formula lives in one place."""
    safe = jnp.maximum(counts, 1.0)
    return jnp.where(
        (counts > 0)[..., None], sums / safe[..., None], 0.0
    ).astype(dtype)


def losses_from_stats(sums: Array, counts: Array, sumsq: Array, n_elems) -> Array:
    """Per-subquantizer Lloyd's loss from sufficient statistics:
    ``sse_j = sumsq_j - sum_k ||S_jk||^2 / n_jk`` over nonempty centroids,
    normalized by the element count (``src/kmeans.rs:359``).  All f32."""
    safe = jnp.maximum(counts, 1.0)
    s_norms = jnp.sum(sums * sums, axis=-1)
    explained = jnp.sum(jnp.where(counts > 0, s_norms / safe, 0.0), axis=-1)
    return (sumsq.astype(jnp.float32) - explained) / jnp.float32(n_elems)


def assign_stats_streamed(
    x: Array,
    codebooks: Array,
    *,
    chunk: int = 32768,
    use_kernel: bool = False,
    projection: Optional[Array] = None,
) -> tuple[Array, Array]:
    """Per-centroid f32 sums ``(m, k, ds)`` and counts ``(m, k)`` under
    nearest-centroid assignment, never materializing anything O(n * k):
    a ``lax.scan`` over ``chunk``-row slices of :func:`_chunk_stats`.
    With ``projection``, chunks are rotated on the fly before assignment
    — the rotated corpus is never materialized.  Also the per-shard
    building block of the sharded trainer (``reductive_tpu.parallel``)."""
    n, d = x.shape
    m, k, ds = codebooks.shape

    def stats(xc):
        if projection is not None:
            xc = jnp.dot(xc, projection, precision="highest")
        return _chunk_stats(codebooks, xc, use_kernel)

    def body(carry, xc):
        s, c = carry
        s2, c2 = stats(xc)
        return (s + s2, c + c2), None

    init = (
        jnp.zeros((m, k, ds), jnp.float32),
        jnp.zeros((m, k), jnp.float32),
    )
    n_main = (n // chunk) * chunk
    sums, counts = init
    if n_main:
        (sums, counts), _ = jax.lax.scan(
            body, init, x[:n_main].reshape(-1, chunk, d)
        )
    if n_main < n:
        s2, c2 = stats(x[n_main:])
        sums, counts = sums + s2, counts + c2
    return sums, counts


@partial(jax.jit, static_argnames=("chunk", "use_kernel"))
def lloyd_iteration_chunked(
    x: Array,
    codebooks: Array,
    sumsq: Array,
    *,
    chunk: int = 32768,
    use_kernel: bool = False,
    projection: Optional[Array] = None,
) -> tuple[Array, Array]:
    """One Lloyd's step over all ``m`` subquantizers, streaming ``x`` in
    ``chunk``-row slices so peak memory is O(chunk * (d + m*k)) instead of
    O(n * m * k).

    ``sumsq`` is the per-subquantizer ``sum ||x||^2`` vector ``(m,)`` of
    the (rotated, if ``projection`` is given) data — constant across
    iterations.  Returns the updated ``(m, k, ds)`` codebooks and
    per-subquantizer f32 losses ``(m,)`` normalized by ``n * ds`` (the
    reference's element-count convention, src/kmeans.rs:359).
    ``use_kernel`` selects the GPU encode kernel for the assignment
    (:func:`reductive_tpu.dispatch.use_kernel`).
    """
    n, d = x.shape
    m, k, ds = codebooks.shape
    sums, counts = assign_stats_streamed(
        x, codebooks, chunk=chunk, use_kernel=use_kernel, projection=projection,
    )
    new_codebooks = centroids_from_stats(sums, counts, codebooks.dtype)
    losses = losses_from_stats(sums, counts, sumsq, n * ds)
    return new_codebooks, losses


def train_pq_chunked(
    key: Array,
    instances: Array,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    chunk: int = 32768,
    use_kernel: Optional[bool] = None,
    projection: Optional[Array] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    initial_model: Optional[Pq] = None,
) -> Pq:
    """Large-corpus PQ training: same semantics as :func:`train_pq`, but
    every Lloyd's iteration streams the instances chunk-by-chunk with the
    fused assign kernel, so training scales to any ``n`` that fits in HBM
    as raw data (and composes with the sharded data-parallel path for
    corpora beyond one card).

    With ``projection`` (an orthonormal ``(d, d)`` rotation), chunks are
    rotated on the fly — training happens in the rotated space without
    ever materializing the rotated corpus, and the returned model carries
    the projection (this is how ``train_gaussian_opq_chunked`` composes).

    Attempts run as an outer loop over the same compiled step (initial
    centroids differ, shapes do not), keeping the per-subquantizer
    minimum-loss attempt like the reference (``src/pq/pq.rs:168-188``).

    ``use_kernel=None`` (default) lets
    :func:`reductive_tpu.dispatch.use_kernel` choose the encode kernel or
    the einsum.  With ``checkpoint_every=e`` and
    ``checkpoint_path``, the current attempt's state is written atomically
    as an :mod:`reductive_tpu.io` artifact every ``e`` iterations (the
    reference has no fault handling at all, SURVEY.md §5); a killed job
    restarts via ``initial_model=io.load(path)``, which runs the
    remaining iterations from the saved codebooks (resume is inherently
    single-attempt: pass ``n_attempts=1``).  Segmenting the loop does
    not retrace (iteration counts are traced values).
    """
    if checkpoint_every is not None:
        if checkpoint_path is None:
            raise ValueError("checkpoint_every requires checkpoint_path")
        if checkpoint_every <= 0:
            raise ValueError("checkpoint_every must be >= 1")
    n, d = instances.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    m = n_subquantizers
    k = 2 ** n_subquantizer_bits
    ds = d // m
    from ..dispatch import use_kernel as choose

    use_kernel = choose("encode", use_kernel)
    logger.info(
        "Training %d PQ subquantizers chunked (k=%d, %d iterations, "
        "%d attempts, chunk=%d)",
        m, k, n_iterations, n_attempts, chunk,
    )
    log_it = logger.isEnabledFor(logging.INFO)

    sumsq = _streamed_sumsq(instances, m, chunk=chunk, projection=projection)

    if initial_model is not None:
        if n_attempts != 1:
            raise ValueError(
                "initial_model resume requires n_attempts=1 (the saved "
                "state is a single attempt's codebooks)"
            )
        if initial_model.codebooks.shape != (m, k, ds):
            raise ValueError(
                f"initial_model codebooks have shape "
                f"{initial_model.codebooks.shape}, expected {(m, k, ds)}"
            )

    best_cb, best_loss = None, None
    for attempt in range(n_attempts):
        akey = jax.random.fold_in(key, attempt)
        cb = (
            initial_model.codebooks
            if initial_model is not None
            else _init_chunked_codebooks(akey, instances, projection, m=m, k=k)
        )
        loss = jnp.full((m,), jnp.inf, dtype=jnp.float32)
        done = 0
        while done < n_iterations:
            seg = (
                n_iterations - done
                if checkpoint_every is None
                else min(checkpoint_every, n_iterations - done)
            )
            cb, loss = _run_chunked_attempt(
                instances, sumsq, cb, seg, projection,
                chunk=chunk, use_kernel=use_kernel, start_iteration=done,
                log_iterations=log_it,
            )
            done += seg
            if checkpoint_every is not None:
                from .. import io as _io_mod

                _io_mod.save(
                    checkpoint_path, Pq(codebooks=cb, projection=projection)
                )
                logger.info(
                    "Checkpointed PQ state (attempt %d, %d/%d iterations) to %s",
                    attempt, done, n_iterations, checkpoint_path,
                )
        if best_cb is None:
            best_cb, best_loss = cb, loss
        else:
            better = loss < best_loss  # strict: ties keep earlier attempt
            best_cb = jnp.where(better[:, None, None], cb, best_cb)
            best_loss = jnp.minimum(best_loss, loss)
    return Pq(codebooks=best_cb, projection=projection)


@partial(jax.jit, static_argnames=("m", "chunk"))
def _streamed_sumsq(
    x: Array, m: int, *, chunk: int, projection: Optional[Array] = None
) -> Array:
    """Per-subquantizer ``sum ||x||^2`` in f32, streamed in chunks and
    rotating on the fly when a projection is given (the rotated corpus is
    never materialized)."""
    n, d = x.shape
    ds = d // m

    def sq(xc):
        if projection is not None:
            xc = jnp.dot(xc, projection, precision="highest")
        return jnp.sum(
            xc.reshape(-1, m, ds).astype(jnp.float32) ** 2, axis=(0, 2)
        )

    n_main = (n // chunk) * chunk
    total = jnp.zeros((m,), jnp.float32)
    if n_main:
        total, _ = jax.lax.scan(
            lambda c, xc: (c + sq(xc), None),
            total,
            x[:n_main].reshape(-1, chunk, d),
        )
    if n_main < n:
        total = total + sq(x[n_main:])
    return total


def _log_lloyd_iteration(i, loss) -> None:
    """Host-side per-iteration log line for the chunked trainers (the
    reference returns losses from each ``kmeans_iteration`` but logs only
    phase markers; here the whole loop is on-device, so the trajectory
    surfaces through ``jax.debug.callback``)."""
    logger.info("Lloyd's iteration %d: mean subquantizer loss %.6f", int(i), float(loss))


@partial(jax.jit, static_argnames=("m", "k"))
def _init_chunked_codebooks(key, x, projection, *, m: int, k: int):
    """Initial codebooks for one chunked training attempt (module-level
    jit: the compile cache survives across ``train_pq_chunked`` calls)."""
    keys = jax.random.split(key, m)
    return init_codebooks_random(x, keys, k, x.shape[1] // m, projection)


@partial(
    jax.jit,
    static_argnames=("chunk", "use_kernel", "log_iterations"),
)
def _run_chunked_attempt(
    x, sumsq, codebooks, n_iterations, projection, *, chunk, use_kernel,
    start_iteration=0, log_iterations: bool = False,
):
    """Lloyd's iterations of one chunked training attempt from given
    codebooks.  ``n_iterations`` and ``start_iteration`` are traced, so one
    compilation serves every iteration count and checkpoint segment."""
    m = codebooks.shape[0]

    def body(i, carry):
        cb, _ = carry
        cb, losses = lloyd_iteration_chunked(
            x, cb, sumsq, chunk=chunk, use_kernel=use_kernel,
            projection=projection,
        )
        if log_iterations:
            jax.debug.callback(
                _log_lloyd_iteration, start_iteration + i, jnp.mean(losses)
            )
        return cb, losses

    init_loss = jnp.full((m,), jnp.inf, dtype=jnp.float32)
    return jax.lax.fori_loop(0, n_iterations, body, (codebooks, init_loss))

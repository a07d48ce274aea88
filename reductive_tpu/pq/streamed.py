"""Host-streamed training: corpora larger than HBM.

The chunked trainers (:func:`reductive_tpu.pq.train.train_pq_chunked`,
:func:`reductive_tpu.pq.opq.train_opq_chunked`) stream *within* HBM — the
corpus is a device-resident array.  BASELINE.json's config #5 (100M 768-d
vectors, ~307 GB f32) does not fit in any card's memory, so these trainers
re-stream the corpus **from disk** through the native double-buffered
reader every Lloyd's iteration:

* the only device-resident state is the ``(m, k, ds)`` codebooks plus
  f32 sufficient statistics (sums/counts/sum-of-squares — a few MB);
* each disk batch flows host-read → (optional bf16 wire cast) →
  host-to-device copy → one jitted accumulate step.  JAX dispatch is
  asynchronous, so the reader's native prefetch thread fills batch
  ``i+1`` while the device reduces batch ``i`` — the same overlap
  structure as :func:`reductive_tpu.data.stream_encode_batches`;
* Lloyd's update and loss come from the one-pass sufficient-statistics
  identity (see ``pq/train.py``), so one read of the corpus per
  iteration suffices.  OPQ needs two (statistics, then the Procrustes
  cross-matrix against the *updated* codebooks — the reference quantizes
  after the k-means step, ``src/pq/opq.rs:161-189``).

Initial centroids draw the same per-subquantizer
``random_distinct_indices`` streams as the in-HBM chunked trainers (the
draw depends only on ``(key, n, k)``), then fetch exactly those rows from
the reader — so at matched keys and batch sizes ``train_pq_streamed``
reproduces ``train_pq_chunked`` bit-for-bit (asserted in
``tests/test_streamed.py``).

Throughput note: a training pass is expected to be bound by the host
read and the host-to-device copy, not by the device's reduction.
``transfer_dtype=jnp.bfloat16`` halves the bytes on the wire;
assignments are computed from the cast values, while statistics still
accumulate in f32.
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import Array

from ..errors import check_quantizer_invariants
from ..kmeans import random_distinct_indices
from .model import Pq
from .train import centroids_from_stats, losses_from_stats

logger = logging.getLogger("reductive_tpu")

__all__ = [
    "train_pq_streamed",
    "train_opq_streamed",
    "train_gaussian_opq_streamed",
    "streamed_covariance",
]


@partial(jax.jit, static_argnames=("use_kernel",))
def _stats_step(acc, codebooks, projection, xb, *, use_kernel):
    """Accumulate one batch into (sums, counts, sumsq); the projection (if
    any) rotates the batch on device so the rotated corpus never exists."""
    from .train import _chunk_stats

    sums, counts, sumsq = acc
    x = xb.astype(codebooks.dtype)
    if projection is not None:
        x = jnp.dot(x, projection, precision="highest")
    m, k, ds = codebooks.shape
    s2, c2 = _chunk_stats(codebooks, x, use_kernel)
    xs = x.reshape(-1, m, ds).astype(jnp.float32)
    sq2 = jnp.sum(xs * xs, axis=(0, 2))
    return (sums + s2, counts + c2, sumsq + sq2)


@partial(jax.jit, static_argnames=("use_kernel",))
def _cross_step(M, codebooks, projection, xb, *, use_kernel):
    """Accumulate one batch of the OPQ Procrustes cross-matrix
    ``M += x^T reconstruct(encode(x R))`` (``src/pq/opq.rs:178-187``)."""
    from ..dispatch import encode
    from . import primitives

    x = xb.astype(codebooks.dtype)
    rx = jnp.dot(x, projection, precision="highest")
    codes = encode(codebooks, rx, dtype=jnp.int32, use_kernel=use_kernel)
    rec = primitives.reconstruct_batch(codebooks, codes)
    return M + jnp.dot(x.T, rec, precision="highest").astype(jnp.float32)


@jax.jit
def _cov_step(acc, xb):
    """Accumulate (sum x, x^T x, n) for the streamed covariance."""
    s1, s2, cnt = acc
    x = xb.astype(jnp.float32)
    return (
        s1 + jnp.sum(x, axis=0),
        s2 + jnp.dot(x.T, x, precision="highest"),
        cnt + x.shape[0],
    )


def _reader_batches(reader, batch_size: int, start: int, stop: int):
    from ..data import _reader_batches as rb

    return rb(reader, batch_size, start, stop)


def _stream_pass(reader, batch_size, start, stop, transfer_dtype, step, acc):
    """One full pass over the reader, accumulating via
    ``step(acc, xb) -> acc``; full batches share one compiled program."""
    for _, batch in _reader_batches(reader, batch_size, start, stop):
        if transfer_dtype is not None:
            batch = np.asarray(batch).astype(transfer_dtype)
        acc = step(acc, jnp.asarray(batch))
    return acc


def streamed_covariance(
    reader, *, batch_size: int = 1 << 18, start: int = 0,
    stop: Optional[int] = None, transfer_dtype=None,
) -> Array:
    """Covariance of an on-disk corpus in one streamed pass.

    Moment form ``(x^T x - n mu mu^T) / (n - 1)`` accumulated in f32 on
    device — numerically within float tolerance of the reference's
    two-pass centered form (``src/linalg.rs:17-45``) for data that is not
    pathologically far from the origin (embedding corpora are roughly
    centered; the OPQ eigenbasis is insensitive to ~1e-5 covariance
    perturbations)."""
    stop = reader.n if stop is None else min(stop, reader.n)
    d = reader.dim
    acc = (
        jnp.zeros((d,), jnp.float32),
        jnp.zeros((d, d), jnp.float32),
        jnp.zeros((), jnp.float32),
    )
    for _, batch in _reader_batches(reader, batch_size, start, stop):
        if transfer_dtype is not None:
            batch = np.asarray(batch).astype(transfer_dtype)
        acc = _cov_step(acc, jnp.asarray(batch))
    s1, s2, cnt = acc
    mean = s1 / cnt
    return (s2 - cnt * jnp.outer(mean, mean)) / (cnt - 1.0)


@partial(jax.jit, static_argnames=("n", "k"))
def _draw_init_indices(keys: Array, n: int, k: int) -> Array:
    """All ``m`` subquantizers' initial index draws in ONE dispatch.  vmap
    of a keyed draw equals the sequential calls."""
    return jax.vmap(lambda kk: random_distinct_indices(kk, n, k))(keys)


def _init_streamed_codebooks(
    key: Array, reader, m: int, k: int, ds: int,
    projection: Optional[Array], start: int, stop: int,
) -> Array:
    """Initial ``(m, k, ds)`` codebooks: the same per-subquantizer
    ``random_distinct_indices`` draws as ``_init_chunked_codebooks``
    (bit-identical — the draw depends only on ``(key, n, k)``), with the
    drawn rows fetched from disk instead of gathered from HBM."""
    n = stop - start
    d = m * ds
    # The index draw is a few thousand threefry words + a small stable
    # sort, so it runs on the host CPU backend next to the reader that
    # fetches the rows.  JAX PRNG streams are platform-invariant, so the
    # values are the device's.
    try:
        cpu = jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        cpu = None
    with jax.default_device(cpu):
        keys = jax.random.split(jax.device_put(key, cpu), m)
        idx = np.asarray(_draw_init_indices(keys, n, k))  # (m, k)
    if hasattr(reader, "read_rows"):
        rows = reader.read_rows((idx + start).ravel())
    else:
        rows = np.concatenate(
            [reader.read(start + int(i), 1) for i in idx.ravel()]
        )
    if projection is not None:
        rows = np.asarray(
            jnp.dot(jnp.asarray(rows), projection, precision="highest")
        )
    rows = rows.reshape(m, k, d)
    cb = np.stack([rows[j][:, j * ds : (j + 1) * ds] for j in range(m)])
    return jnp.asarray(cb)


def train_pq_streamed(
    key: Array,
    reader,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    batch_size: int = 1 << 18,
    use_kernel: Optional[bool] = None,
    projection: Optional[Array] = None,
    transfer_dtype=None,
    start: int = 0,
    stop: Optional[int] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    initial_model: Optional[Pq] = None,
) -> Pq:
    """PQ training over an on-disk corpus larger than HBM: every Lloyd's
    iteration re-streams ``reader`` (a :class:`reductive_tpu.native
    .VecsReader` or anything with ``n``/``dim``/``read``/``batches``)
    in ``batch_size``-row batches (assignment by
    :func:`reductive_tpu.dispatch.encode`, statistics by
    :func:`reductive_tpu.pq.train.sorted_segment_sum`).

    Same semantics and hyperparameters as :func:`train_pq_chunked`
    (reference: ``TrainPq for Pq``, ``src/pq/pq.rs:196-250``) — at
    matched keys and ``batch_size == chunk`` the result is bit-identical
    to the in-HBM chunked trainer, since initial draws, assignment
    arithmetic, and accumulation order all coincide.  ``projection``
    rotates batches on the fly (how ``train_gaussian_opq_streamed``
    composes).  ``checkpoint_every``/``checkpoint_path``/
    ``initial_model`` behave exactly as on the chunked trainer —
    iteration granularity, atomic artifact, single-attempt resume.
    """
    if checkpoint_every is not None:
        if checkpoint_path is None:
            raise ValueError("checkpoint_every requires checkpoint_path")
        if checkpoint_every <= 0:
            raise ValueError("checkpoint_every must be >= 1")
    stop = reader.n if stop is None else min(stop, reader.n)
    n = stop - start
    d = reader.dim
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    m, k = n_subquantizers, 2 ** n_subquantizer_bits
    ds = d // m
    from ..dispatch import use_kernel as choose

    use_kernel = choose("encode", use_kernel)
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
    logger.info(
        "Training %d PQ subquantizers streamed from disk (k=%d, %d rows, "
        "%d iterations, %d attempts, batch=%d)",
        m, k, n, n_iterations, n_attempts, batch_size,
    )

    def one_pass(cb) -> Tuple[Array, Array, Array]:
        def step(acc, xb):
            return _stats_step(acc, cb, projection, xb, use_kernel=use_kernel)

        acc = (
            jnp.zeros((m, k, ds), jnp.float32),
            jnp.zeros((m, k), jnp.float32),
            jnp.zeros((m,), jnp.float32),
        )
        return _stream_pass(
            reader, batch_size, start, stop, transfer_dtype, step, acc,
        )

    best_cb, best_loss = None, None
    for attempt in range(n_attempts):
        akey = jax.random.fold_in(key, attempt)
        cb = (
            initial_model.codebooks
            if initial_model is not None
            else _init_streamed_codebooks(
                akey, reader, m, k, ds, projection, start, stop
            )
        )
        loss = jnp.full((m,), jnp.inf, jnp.float32)
        for it in range(n_iterations):
            sums, counts, sumsq = one_pass(cb)
            cb = centroids_from_stats(sums, counts, cb.dtype)
            loss = losses_from_stats(sums, counts, sumsq, n * ds)
            logger.info(
                "Streamed Lloyd's iteration %d: mean subquantizer loss %.6f",
                it, float(jnp.mean(loss)),
            )
            if checkpoint_every is not None and (it + 1) % checkpoint_every == 0:
                from .. import io as _io_mod

                _io_mod.save(
                    checkpoint_path, Pq(codebooks=cb, projection=projection)
                )
                logger.info(
                    "Checkpointed streamed PQ state (attempt %d, %d/%d "
                    "iterations) to %s",
                    attempt, it + 1, n_iterations, checkpoint_path,
                )
        if best_cb is None:
            best_cb, best_loss = cb, loss
        else:
            better = loss < best_loss  # strict: ties keep earlier attempt
            best_cb = jnp.where(better[:, None, None], cb, best_cb)
            best_loss = jnp.minimum(best_loss, loss)
    return Pq(codebooks=best_cb, projection=projection)


def train_gaussian_opq_streamed(
    key: Array,
    reader,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    batch_size: int = 1 << 18,
    use_kernel: Optional[bool] = None,
    transfer_dtype=None,
    start: int = 0,
    stop: Optional[int] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    initial_model: Optional[Pq] = None,
) -> Pq:
    """Closed-form OPQ over an on-disk corpus (reference:
    ``src/pq/gaussian_opq.rs:27-69``): one streamed covariance pass builds
    the PCA-bucketed projection, then :func:`train_pq_streamed` trains on
    batches rotated on the fly.  Total disk reads:
    ``(1 + n_iterations)`` passes."""
    from .opq import projection_from_covariance

    if initial_model is not None and initial_model.projection is not None:
        projection = initial_model.projection
    else:
        cov = streamed_covariance(
            reader, batch_size=batch_size, start=start, stop=stop,
            transfer_dtype=transfer_dtype,
        )
        projection = projection_from_covariance(cov, n_subquantizers)
    pq = train_pq_streamed(
        key, reader, n_subquantizers, n_subquantizer_bits, n_iterations,
        n_attempts, batch_size=batch_size, use_kernel=use_kernel,
        projection=projection,
        transfer_dtype=transfer_dtype, start=start, stop=stop,
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        initial_model=initial_model,
    )
    return pq


def train_opq_streamed(
    key: Array,
    reader,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,  # ignored, as in the reference (src/pq/opq.rs:50)
    *,
    batch_size: int = 1 << 18,
    use_kernel: Optional[bool] = None,
    transfer_dtype=None,
    start: int = 0,
    stop: Optional[int] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    initial_model: Optional[Pq] = None,
) -> Pq:
    """Non-parametric OPQ over an on-disk corpus (reference:
    ``TrainPq for Opq``, ``src/pq/opq.rs:40-100``): alternates one
    streamed k-means step with a streamed Procrustes projection update.

    Per alternation the corpus is read twice — once for the centroid
    statistics of the rotated data, once for the cross-matrix
    ``M = X^T reconstruct(encode(X R))`` under the *updated* codebooks
    (the reference quantizes after the k-means step,
    ``src/pq/opq.rs:161-189``) — so a full run costs
    ``1 + 2 * n_iterations`` disk passes (+1 covariance pass).  The
    ``(d, d)`` polar update runs on device
    (:func:`reductive_tpu.pq.opq.polar_orthogonalize`).
    """
    from ..dispatch import use_kernel as choose
    from .opq import polar_orthogonalize, projection_from_covariance

    if checkpoint_every is not None and checkpoint_path is None:
        raise ValueError("checkpoint_every requires checkpoint_path")
    stop = reader.n if stop is None else min(stop, reader.n)
    n = stop - start
    d = reader.dim
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, 1, n, d
    )
    m, k = n_subquantizers, 2 ** n_subquantizer_bits
    ds = d // m
    use_kernel = choose("encode", use_kernel)

    if initial_model is not None:
        projection = initial_model.projection
        cb = initial_model.codebooks
        if projection is None or cb.shape != (m, k, ds):
            raise ValueError("initial_model must carry a projection and "
                             f"(m, k, ds) = {(m, k, ds)} codebooks")
    else:
        cov = streamed_covariance(
            reader, batch_size=batch_size, start=start, stop=stop,
            transfer_dtype=transfer_dtype,
        )
        projection = projection_from_covariance(cov, m)
        cb = _init_streamed_codebooks(
            key, reader, m, k, ds, projection, start, stop
        )

    def stream(fn, acc, *args):
        def step(a, xb):
            return fn(a, *args, xb, use_kernel=use_kernel)

        return _stream_pass(
            reader, batch_size, start, stop, transfer_dtype, step, acc,
        )

    for it in range(n_iterations):
        logger.info("Streamed OPQ iteration %d", it)
        sums, counts, sumsq = stream(
            _stats_step,
            (
                jnp.zeros((m, k, ds), jnp.float32),
                jnp.zeros((m, k), jnp.float32),
                jnp.zeros((m,), jnp.float32),
            ),
            cb, projection,
        )
        cb = centroids_from_stats(sums, counts, cb.dtype)
        loss = losses_from_stats(sums, counts, sumsq, n * ds)
        logger.info(
            "Streamed OPQ iteration %d: mean subquantizer loss %.6f",
            it, float(jnp.mean(loss)),
        )
        M = stream(_cross_step, jnp.zeros((d, d), jnp.float32), cb, projection)
        projection = polar_orthogonalize(M.astype(cb.dtype))
        if checkpoint_every is not None and (it + 1) % checkpoint_every == 0:
            from .. import io as _io_mod

            _io_mod.save(checkpoint_path, Pq(codebooks=cb, projection=projection))
            logger.info(
                "Checkpointed streamed OPQ state (%d/%d iterations) to %s",
                it + 1, n_iterations, checkpoint_path,
            )
    return Pq(codebooks=cb, projection=projection)

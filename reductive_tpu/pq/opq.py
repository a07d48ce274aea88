"""Optimized product quantization (Ge et al., 2013): learned rotations.

Counterpart of the reference's ``Opq`` trainer (reference:
``src/pq/opq.rs``).  OPQ learns an orthonormal ``(d, d)`` projection that
balances variance across the ``m`` subquantizers, alternating between
codebook refinement and a Procrustes update of the rotation.

Design differences from the reference, all for a device-resident program:

* the eigendecomposition and SVD run **on device** through
  ``jnp.linalg.eigh``/``jnp.linalg.svd`` instead of LAPACK calls
  (reference: ``src/pq/opq.rs:123,187``);
* the per-subquantizer single k-means iterations — rayon tasks in the
  reference (``src/pq/opq.rs:198-208``) — are one ``vmap`` over the ``m``
  axis;
* the whole alternating loop is a ``lax.fori_loop`` inside a single
  ``jit``, so data never bounces to the host between iterations.  The only
  host-side step is the greedy eigenvalue bucketing (tiny, done once) —
  exactly the split recommended by the structure of the algorithm.
"""

from __future__ import annotations

import logging
from functools import partial
from typing import List, Optional

import numpy as np

logger = logging.getLogger("reductive_tpu")

import jax
import jax.numpy as jnp
from jax import Array

from ..errors import check_quantizer_invariants
from ..kmeans import kmeans_iteration
from ..linalg import covariance
from . import primitives
from .model import Pq
from .train import train_pq_subspace

__all__ = [
    "bucket_eigenvalues",
    "create_projection_matrix",
    "train_opq",
    "train_opq_chunked",
    "train_gaussian_opq",
    "train_gaussian_opq_chunked",
]


def bucket_eigenvalues(eigenvalues: np.ndarray, n_buckets: int) -> List[List[int]]:
    """Distribute eigenvalue indices over ``n_buckets`` so the product of
    eigenvalues (total variance) is balanced across buckets.

    Host-side greedy algorithm matching the reference exactly
    (``src/pq/opq.rs:212-273``): sort ascending, then repeatedly take the
    largest remaining eigenvalue and place it in the non-full bucket with
    the smallest log-space product (ties to the first bucket).  Each bucket
    holds exactly ``len(eigenvalues) / n_buckets`` entries.
    """
    eigenvalues = np.asarray(eigenvalues)
    if n_buckets <= 0:
        raise ValueError("Cannot distribute eigenvalues over zero buckets.")
    if len(eigenvalues) < n_buckets:
        raise ValueError("At least one eigenvalue is required per bucket")
    if len(eigenvalues) % n_buckets != 0:
        raise ValueError(
            "The number of eigenvalues should be a multiple of the number of buckets."
        )

    order = list(np.argsort(eigenvalues, kind="stable"))
    eps = np.finfo(eigenvalues.dtype if eigenvalues.dtype.kind == "f" else np.float64).eps
    if eigenvalues[order[0]] < -eps:
        raise ValueError("Bucketing is only supported for positive eigenvalues.")

    # Log-space products to avoid over/underflow; shift so all values are
    # non-negative, making (0, 1] and [1, inf) eigenvalues comparable.
    logs = np.log(eigenvalues.astype(np.float64) + eps)
    logs -= logs.min()

    max_assignments = len(eigenvalues) // n_buckets
    assignments: List[List[int]] = [[] for _ in range(n_buckets)]
    products = [0.0] * n_buckets

    while order:
        idx = int(order.pop())  # largest remaining
        bucket = min(
            (b for b in range(n_buckets) if len(assignments[b]) < max_assignments),
            key=lambda b: products[b],
        )
        assignments[bucket].append(idx)
        products[bucket] += logs[idx]

    return assignments


def create_projection_matrix(instances: Array, n_subquantizers: int) -> Array:
    """PCA-bucketed initial projection (reference:
    ``src/pq/opq.rs:103-136``): eigendecompose the covariance matrix,
    balance the principal directions over the subquantizers by eigenvalue
    bucketing, and assemble the permuted eigenvectors as columns.

    The eigendecomposition runs on device; only the ``d`` eigenvalues come
    back to the host for the (tiny, one-shot) greedy bucketing.
    """
    # Phase marker mirroring the reference (src/pq/opq.rs:112-117).
    logger.info(
        "Creating projection matrix (%d instances, %d dimensions, %d subquantizers)",
        instances.shape[0], instances.shape[1], n_subquantizers,
    )
    return projection_from_covariance(covariance(instances, 0), n_subquantizers)


def projection_from_covariance(cov: Array, n_subquantizers: int) -> Array:
    """The eigendecompose-and-bucket half of :func:`create_projection_matrix`
    for callers that already hold the covariance matrix — e.g. the
    host-streamed trainers, which accumulate it over disk batches without
    ever materializing the corpus in HBM."""
    eigen_values, eigen_vectors = jnp.linalg.eigh(cov)
    buckets = bucket_eigenvalues(np.asarray(eigen_values), n_subquantizers)
    permutation = np.array([idx for bucket in buckets for idx in bucket], dtype=np.int32)
    return eigen_vectors[:, permutation]


def polar_orthogonalize(M: Array, iterations: int = 40) -> Array:
    """The orthogonal polar factor of a full-rank square matrix via
    Newton–Schulz iteration — the Procrustes solution ``R = U V^T`` of
    ``svd(M)`` (Ge et al., 2013, Eq. 7) without an SVD.

    ``X ← 1.5 X − 0.5 X Xᵀ X`` converges quadratically to the polar factor
    once ``‖X‖₂ < √3``; normalizing by the Frobenius norm guarantees that.
    Small singular values first grow ×1.5 per step, so 40 iterations
    cover condition numbers up to ~1e7 — beyond what f32 SVD resolves
    anyway.  Everything is a ``(d, d)`` matmul, which replaces an
    iterative ``jnp.linalg.svd`` with a fixed count of matmuls — the
    polar factor is unique for full-rank input, so the
    result matches ``U V^T`` from an SVD to float tolerance.  A runtime
    orthogonality check re-orthonormalizes rank-deficient /
    ill-conditioned results through a QR completion (see inline comment).
    """
    X = M / jnp.linalg.norm(M)

    def body(_, X):
        XXt = jnp.dot(X, X.T, precision="highest")
        return 1.5 * X - 0.5 * jnp.dot(XXt, X, precision="highest")

    R = jax.lax.fori_loop(0, iterations, body, X)
    # Rank-deficient M — structural when m*k < d (rank(X_hat) <= m*k),
    # but also possible for data reasons (n < d, degenerate columns,
    # zero-filled empty clusters) — leaves null-space singular values at
    # zero, so R would not be orthogonal.  The guard is always on:
    # orthonormality is the hard requirement (the model applies R^T as
    # the inverse), and the completion of deficient directions is
    # arbitrary for Procrustes anyway.  QR re-orthonormalizes the
    # Newton-Schulz output (agreeing with it up to f32 noise when R is
    # already orthogonal) and compiles far more cheaply than a
    # jnp.linalg.svd branch; two polish steps tighten QR's result to f32
    # eps.
    err = jnp.max(jnp.abs(jnp.dot(R.T, R, precision="highest") - jnp.eye(M.shape[0])))

    def qr_route(R):
        q, r = jnp.linalg.qr(R)
        # Fix QR's sign convention so q stays close to R (diag(r) >= 0).
        q = q * jnp.where(jnp.diagonal(r) < 0, -1.0, 1.0)[None, :]
        return jax.lax.fori_loop(0, 2, body, q)

    return jax.lax.cond(err < 1e-3, lambda R: R, qr_route, R)


def _log_opq_iteration(i, loss) -> None:
    """Host-side per-iteration log line — the counterpart of the
    reference's ``info!("Iteration {}", ...)`` (``src/pq/opq.rs:87``),
    carrying the mean subquantizer loss the reference computes but never
    surfaces."""
    logger.info("OPQ iteration %d: loss %.6f", int(i), float(loss))


@partial(jax.jit, static_argnames=("log_iterations",))
def _alternate(
    x: Array,
    projection: Array,
    codebooks: Array,
    n_iterations: Array,
    log_iterations: bool = False,
) -> tuple[Array, Array]:
    """The OPQ alternating-minimization loop, fully jitted.

    Each iteration (reference: ``train_iteration``, ``src/pq/opq.rs:161-189``):

    1. rotate all instances by the current projection;
    2. one Lloyd's iteration per subquantizer (vmapped over ``m``);
    3. quantize→reconstruct roundtrip in the rotated space;
    4. Procrustes update: ``R = U V^T`` from ``svd(X^T X_hat)``
       (Ge et al., 2013, Eq. 7).

    ``n_iterations`` is a *runtime* value (the ``fori_loop`` bound may be
    traced), so one ~50 s compilation serves every iteration count.  With
    ``log_iterations`` the loop emits the reference's per-iteration log
    line (``src/pq/opq.rs:87``) plus the mean subquantizer loss through
    ``jax.debug.callback`` — the loss trajectory is visible even though
    all iterations run on device.
    """
    m, k, ds = codebooks.shape
    n = x.shape[0]

    def body(i, carry):
        projection, codebooks = carry
        rx = jnp.dot(x, projection, precision="highest")
        rxs = jnp.moveaxis(rx.reshape(n, m, ds), 1, 0)  # (m, n, ds)
        codebooks, losses = jax.vmap(lambda xs, c: kmeans_iteration(xs, c))(
            rxs, codebooks
        )
        if log_iterations:
            jax.debug.callback(_log_opq_iteration, i, jnp.mean(losses))
        codes = primitives.quantize_batch(codebooks, rx, dtype=jnp.int32)
        reconstructed = primitives.reconstruct_batch(codebooks, codes)
        M = jnp.dot(x.T, reconstructed, precision="highest")
        return polar_orthogonalize(M), codebooks

    return jax.lax.fori_loop(0, n_iterations, body, (projection, codebooks))


def train_opq(
    key: Array,
    instances: Array,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
) -> Pq:
    """Train an optimized product quantizer (reference: ``TrainPq for Opq``,
    ``src/pq/opq.rs:40-100``).

    Like the reference, training always uses a single attempt —
    ``n_attempts`` is accepted for API parity but has no effect
    (``src/pq/opq.rs:35-37,50``).
    """
    n, d = instances.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, 1, n, d
    )
    k = 2 ** n_subquantizer_bits
    ds = d // n_subquantizers

    projection = create_projection_matrix(instances, n_subquantizers)
    rx = jnp.dot(instances, projection, precision="highest")

    # Initial centroids: k distinct random instances per subquantizer slice
    # of the rotated data (reference: src/pq/opq.rs:71-83,138-159).
    rxs = rx.reshape(n, n_subquantizers, ds)
    keys = jax.random.split(key, n_subquantizers)

    def init_one(key, xs):
        idx = jax.random.choice(key, n, shape=(k,), replace=False)
        return jnp.take(xs, idx, axis=0)

    codebooks = jax.vmap(init_one)(keys, jnp.moveaxis(rxs, 1, 0))

    # The reference logs each iteration and phase from the host
    # (src/pq/opq.rs:87,170,176); here the iterations run inside one
    # jitted fori_loop, with the per-iteration line (plus the loss the
    # reference never surfaces) emitted through jax.debug.callback.
    logger.info(
        "Running %d OPQ iterations (subquantizer update + Procrustes "
        "projection update per iteration, jitted end-to-end)",
        n_iterations,
    )
    projection, codebooks = _alternate(
        instances, projection, codebooks, n_iterations,
        log_iterations=logger.isEnabledFor(logging.INFO),
    )
    return Pq(codebooks=codebooks, projection=projection)


def _opq_iteration_chunked(
    x: Array, projection: Array, codebooks: Array, *,
    chunk: int, use_kernel: bool, axis_name: Optional[str] = None,
):
    """One OPQ alternation at corpus scale, streaming over ``n``.

    Mirrors the reference's ``train_iteration`` (``src/pq/opq.rs:161-189``)
    without ever materializing the rotated corpus, the ``(m, n, k)``
    distance tensor, or the reconstruction:

    1. per-centroid sums/counts of the rotated data (chunks rotated on
       the fly, :func:`reductive_tpu.pq.train.assign_stats_streamed`) →
       codebook update;
    2. codes under the **updated** codebooks (the reference quantizes
       after the k-means step) and the Procrustes cross-matrix
       ``M = X^T X_hat`` accumulated per chunk as
       ``x_chunk^T @ gather(codebooks, codes)`` — one full-depth matmul
       per chunk;
    3. ``R = U V^T`` from ``svd(M)`` (Ge et al., 2013, Eq. 7).

    With ``axis_name`` (inside ``shard_map``), ``x`` is this device's
    shard and both the centroid statistics and ``M`` are psum-reduced
    before the update/SVD — the data-parallel form; everything after the
    psums is replicated.
    """
    from ..dispatch import encode
    from ..pq.train import assign_stats_streamed

    n, d = x.shape
    m, k, ds = codebooks.shape

    def rotate(xc):
        return jnp.dot(xc, projection, precision="highest")

    # Pass 1: k-means statistics on rotated chunks.
    def stats_body(carry, xc):
        s, c = carry
        rxc = rotate(xc)
        s2, c2 = assign_stats_streamed(
            rxc, codebooks, chunk=chunk, use_kernel=use_kernel,
        )
        return (s + s2, c + c2), None

    n_main = (n // chunk) * chunk
    init = (jnp.zeros((m, k, ds), jnp.float32), jnp.zeros((m, k), jnp.float32))
    sums, counts = init
    if n_main:
        (sums, counts), _ = jax.lax.scan(
            stats_body, init, x[:n_main].reshape(-1, chunk, d)
        )
    if n_main < n:
        (sums, counts), _ = stats_body((sums, counts), x[n_main:])
    if axis_name is not None:
        sums = jax.lax.psum(sums, axis_name)
        counts = jax.lax.psum(counts, axis_name)
    from .train import centroids_from_stats

    new_codebooks = centroids_from_stats(sums, counts, x.dtype)

    # Pass 2: codes under the updated codebooks; accumulate M = X^T X_hat.
    def cross_body(carry, xc):
        codes = encode(new_codebooks, rotate(xc), dtype=jnp.int32,
                       use_kernel=use_kernel)
        rec = primitives.reconstruct_batch(new_codebooks, codes)
        return carry + jnp.dot(xc.T, rec, precision="highest"), None

    M = jnp.zeros((d, d), jnp.float32)
    if n_main:
        M, _ = jax.lax.scan(cross_body, M, x[:n_main].reshape(-1, chunk, d))
    if n_main < n:
        M, _ = cross_body(M, x[n_main:])
    if axis_name is not None:
        M = jax.lax.psum(M, axis_name)
    # Explained sum-of-squares of the (already global, post-psum) stats:
    # sse = sum||x||^2 - explained, so callers can surface the loss
    # trajectory without a second pass over the data.
    safe = jnp.maximum(counts, 1.0)
    explained = jnp.sum(
        jnp.where(counts > 0, jnp.sum(sums * sums, axis=-1) / safe, 0.0)
    )
    return polar_orthogonalize(M.astype(x.dtype)), new_codebooks, explained


@partial(jax.jit, static_argnames=("k", "ds"))
def _init_opq_codebooks(x, keys, projection, k: int, ds: int):
    """Initial centroids for the chunked OPQ: k distinct random instances
    per subquantizer, rotated on the fly (reference:
    ``src/pq/opq.rs:71-83,138-159``)."""
    from .train import init_codebooks_random

    return init_codebooks_random(x, keys, k, ds, projection)


@partial(
    jax.jit,
    static_argnames=("chunk", "use_kernel", "log_iterations"),
)
def _alternate_chunked(
    x, projection, codebooks, n_iterations, *, chunk, use_kernel,
    total_sumsq=None, start_iteration=0, log_iterations: bool = False,
):
    n, d = x.shape

    def body(i, carry):
        proj, cb = carry
        proj, cb, explained = _opq_iteration_chunked(
            x, proj, cb, chunk=chunk, use_kernel=use_kernel,
        )
        if log_iterations and total_sumsq is not None:
            loss = (total_sumsq - explained) / jnp.float32(n * d)
            jax.debug.callback(_log_opq_iteration, start_iteration + i, loss)
        return proj, cb

    return jax.lax.fori_loop(0, n_iterations, body, (projection, codebooks))


def train_opq_chunked(
    key: Array,
    instances: Array,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    chunk: int = 32768,
    use_kernel: Optional[bool] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    initial_model: Optional[Pq] = None,
) -> Pq:
    """Corpus-scale OPQ: the same alternating minimization as
    :func:`train_opq` (reference: ``src/pq/opq.rs:40-100``; ``n_attempts``
    ignored as in the reference) with every pass over the data streamed —
    suitable for ``n`` where the rotated corpus or the ``(m, n, k)``
    distance tensor cannot be materialized.  ``use_kernel=None`` lets
    :func:`reductive_tpu.dispatch.use_kernel` choose the encode kernel or
    the einsum.

    Fault tolerance (the reference has none — SURVEY.md §5): with
    ``checkpoint_every=e`` and ``checkpoint_path``, the
    ``(projection, codebooks)`` state is written atomically as an
    :mod:`reductive_tpu.io` artifact every ``e`` alternations; a killed
    job restarts via ``initial_model=io.load(path)`` (skipping projection
    + codebook init) and loses at most ``e`` alternations.  Segmenting the
    loop does not retrace: the iteration count is a traced value, so one
    compilation serves every segment length.
    """
    if checkpoint_every is not None:
        if checkpoint_path is None:
            raise ValueError("checkpoint_every requires checkpoint_path")
        if checkpoint_every <= 0:
            raise ValueError("checkpoint_every must be >= 1")
    n, d = instances.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, 1, n, d
    )
    k = 2 ** n_subquantizer_bits
    ds = d // n_subquantizers
    from ..dispatch import use_kernel as choose

    use_kernel = choose("encode", use_kernel)

    if initial_model is not None:
        if initial_model.projection is None:
            raise ValueError("initial_model must carry a projection")
        if initial_model.codebooks.shape != (n_subquantizers, k, ds):
            raise ValueError(
                f"initial_model codebooks have shape "
                f"{initial_model.codebooks.shape}, expected {(n_subquantizers, k, ds)}"
            )
        projection, codebooks = initial_model.projection, initial_model.codebooks
    else:
        projection = create_projection_matrix(instances, n_subquantizers)
        keys = jax.random.split(key, n_subquantizers)
        codebooks = _init_opq_codebooks(instances, keys, projection, k, ds)

    logger.info(
        "Running %d chunked OPQ iterations (streamed subquantizer "
        "update + streamed Procrustes accumulation per iteration)",
        n_iterations,
    )
    # Rotation-invariant total sum of squares (orthonormal R preserves
    # norms), computed once for the per-iteration loss trajectory.
    from .train import _streamed_sumsq

    log_it = logger.isEnabledFor(logging.INFO)
    total_sumsq = (
        _streamed_sumsq(instances, 1, chunk=chunk)[0] if log_it else None
    )

    done = 0
    while done < n_iterations:
        seg = (
            n_iterations - done
            if checkpoint_every is None
            else min(checkpoint_every, n_iterations - done)
        )
        projection, codebooks = _alternate_chunked(
            instances, projection, codebooks, seg,
            chunk=chunk, use_kernel=use_kernel,
            total_sumsq=total_sumsq, start_iteration=done,
            log_iterations=log_it,
        )
        done += seg
        if checkpoint_every is not None:
            from .. import io as _io_mod

            _io_mod.save(
                checkpoint_path, Pq(codebooks=codebooks, projection=projection)
            )
            logger.info(
                "Checkpointed OPQ state after %d/%d alternations to %s",
                done, n_iterations, checkpoint_path,
            )
    return Pq(codebooks=codebooks, projection=projection)


def train_gaussian_opq_chunked(
    key: Array,
    instances: Array,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    chunk: int = 32768,
    use_kernel: Optional[bool] = None,
) -> Pq:
    """Corpus-scale GaussianOpq (reference: ``src/pq/gaussian_opq.rs``):
    closed-form rotation once, then :func:`train_pq_chunked` with the
    projection applied chunk-by-chunk on the fly — the rotated corpus is
    never materialized, so peak memory stays at one copy of the input."""
    from .train import train_pq_chunked

    n, d = instances.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    projection = create_projection_matrix(instances, n_subquantizers)
    return train_pq_chunked(
        key, instances, n_subquantizers, n_subquantizer_bits, n_iterations,
        n_attempts, chunk=chunk, use_kernel=use_kernel, projection=projection,
    )


def train_gaussian_opq(
    key: Array,
    instances: Array,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
) -> Pq:
    """Train a Gaussian OPQ (reference: ``TrainPq for GaussianOpq``,
    ``src/pq/gaussian_opq.rs:27-69``): compute the closed-form PCA-bucketed
    rotation once, rotate the data, then run plain PQ training wholesale on
    the rotated instances.  Assumes roughly Gaussian-distributed variables;
    much cheaper than the full alternating OPQ."""
    n, d = instances.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    k = 2 ** n_subquantizer_bits
    ds = d // n_subquantizers

    projection = create_projection_matrix(instances, n_subquantizers)
    rx = jnp.dot(instances, projection, precision="highest")
    codebooks, _ = train_pq_subspace(
        key, rx.reshape(n, n_subquantizers, ds), k, n_iterations, n_attempts
    )
    return Pq(codebooks=codebooks, projection=projection)

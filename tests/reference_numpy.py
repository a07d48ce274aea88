"""Independent host-side numpy implementation of the reference algorithms.

This module exists to turn the 1e-5 parity claim from an argument into a
measurement (VERDICT round 2, item 4): it re-implements the reference's
*exact* training algorithms — per-subquantizer sequential k-means in the
reference's loop order, OPQ's alternating minimization with a real LAPACK
``eigh``/``svd``, f32 arithmetic throughout — in plain numpy, sharing
NOTHING with the device path except the conformance RNG draw stream
(``reductive_tpu.conformance``, itself validated against the independent
ChaCha implementation in the ``cryptography`` package).

A real algorithmic divergence in the device trainers (wrong update rule,
wrong loss normalization, wrong tie-break, wrong alternation order) shows
up as an objective gap here; RNG drift alone cannot hide it because both
sides consume the identical index stream.

Reference structure being mirrored, file:line:

* distances: norm-expansion form ``|u|^2+|v|^2-2uv`` — linalg.rs:150-180
* assignment: row argmin, first-index tie-break — kmeans.rs:133-159
* update: zero-fill, scatter-add, count-guarded divide (empty cluster =>
  zero vector) — kmeans.rs:166-198
* loss: SSE / (n*d) — kmeans.rs:330-360
* k-means driver: assign -> update -> mse per iteration, returns the last
  iteration's loss — kmeans.rs:248-328
* PQ training: per subquantizer, n_attempts x (draw initial centroids
  from the full-width instance rows, run k-means on the column slice),
  keep the min-loss attempt (first minimum wins) — pq.rs:144-188
* OPQ: PCA-bucketed init projection, then per iteration {rotate, ONE
  k-means iteration per subquantizer, quantize/reconstruct roundtrip,
  R <- U Vt of svd(X^T X_hat)} — opq.rs:40-209
* eigenvalue bucketing: greedy log-space balancing — opq.rs:212-273
* GaussianOpq: projection once, then plain PQ training on rotated
  data — gaussian_opq.rs:27-69
"""

from __future__ import annotations

import numpy as np

from reductive_tpu.conformance import ChaCha8Rng, XorShiftRng, distinct_indices


def squared_euclidean_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """linalg.rs:150-180: ``sqn(a)[:,None] + sqn(b)[None,:] - (ab + ab)``."""
    a = np.asarray(a)
    b = np.asarray(b)
    sa = np.einsum("nd,nd->n", a, a)
    sb = np.einsum("kd,kd->k", b, b)
    ab = a @ b.T
    return sa[:, None] + sb[None, :] - (ab + ab)


def cluster_assignments(centroids: np.ndarray, x: np.ndarray) -> np.ndarray:
    """kmeans.rs:133-159: argmin per row; numpy argmin breaks ties to the
    first index exactly like ``min_by_key`` over enumerated distances."""
    return np.argmin(squared_euclidean_distance(x, centroids), axis=1)


def update_centroids(
    centroids: np.ndarray, x: np.ndarray, assignments: np.ndarray
) -> None:
    """kmeans.rs:166-198, in place: empty clusters become the zero vector."""
    centroids.fill(0)
    counts = np.zeros(centroids.shape[0], dtype=centroids.dtype)
    np.add.at(centroids, assignments, x)
    np.add.at(counts, assignments, 1)
    nonzero = counts > 0
    centroids[nonzero] /= counts[nonzero, None]


def mean_squared_error(
    centroids: np.ndarray, x: np.ndarray, assignments: np.ndarray
) -> float:
    """kmeans.rs:330-360: SSE normalized by n*d (instances.len())."""
    err = centroids[assignments] - x
    return float(np.sum(err * err, dtype=x.dtype) / x.dtype.type(x.size))


def kmeans_with_centroids(
    x: np.ndarray, centroids: np.ndarray, n_iterations: int
) -> float:
    """kmeans.rs:248-328: mutates ``centroids``, returns the final loss."""
    loss = np.inf
    for _ in range(n_iterations):
        assignments = cluster_assignments(centroids, x)
        update_centroids(centroids, x, assignments)
        loss = mean_squared_error(centroids, x, assignments)
    return loss


def train_pq(
    x: np.ndarray,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int,
    master: ChaCha8Rng,
) -> np.ndarray:
    """pq.rs:196-250: fork one XorShift per subquantizer from the master,
    then per subquantizer keep the min-loss of ``n_attempts`` runs (the
    FIRST minimum — ``min_by_key`` keeps the earliest on ties).  Returns
    the ``(m, k, ds)`` codebook tensor."""
    n, d = x.shape
    m = n_subquantizers
    k = 2 ** n_subquantizer_bits
    ds = d // m
    rngs = [XorShiftRng.from_rng(master) for _ in range(m)]
    codebooks = np.empty((m, k, ds), dtype=x.dtype)
    for sq, rng in enumerate(rngs):
        sq_x = x[:, sq * ds : (sq + 1) * ds]
        best_loss, best = np.inf, None
        for _ in range(n_attempts):
            idx = distinct_indices(rng, n, k)
            centroids = np.ascontiguousarray(sq_x[idx])
            loss = kmeans_with_centroids(sq_x, centroids, n_iterations)
            if loss < best_loss:  # strict: first minimum wins
                best_loss, best = loss, centroids
        codebooks[sq] = best
    return codebooks


def covariance(x: np.ndarray) -> np.ndarray:
    """linalg.rs:17-45 with observations on Axis(0)."""
    centered = x - x.mean(axis=0, dtype=x.dtype)
    return centered.T @ (centered / x.dtype.type(x.shape[0] - 1))


def bucket_eigenvalues(eigenvalues: np.ndarray, n_buckets: int) -> list:
    """opq.rs:212-273: greedy log-space variance balancing.  Pops the
    largest remaining eigenvalue into the non-full bucket with the
    smallest product (earliest bucket on ties)."""
    ev = np.asarray(eigenvalues)
    order = sorted(range(len(ev)), key=lambda i: ev[i])  # ascending, stable
    eps = np.finfo(ev.dtype).eps
    logs = np.log(ev + ev.dtype.type(eps))
    logs -= logs.min()
    max_per = len(ev) // n_buckets
    assignments: list = [[] for _ in range(n_buckets)]
    products = [ev.dtype.type(0)] * n_buckets
    while order:
        idx = order.pop()  # largest remaining
        bucket = min(
            (b for b in range(n_buckets) if len(assignments[b]) < max_per),
            key=lambda b: products[b],
        )
        assignments[bucket].append(idx)
        products[bucket] += logs[idx]
    return assignments


def create_projection_matrix(x: np.ndarray, n_subquantizers: int) -> np.ndarray:
    """opq.rs:103-136: eigh of the covariance (LAPACK, ascending
    eigenvalues), bucketed columns."""
    eigenvalues, eigenvectors = np.linalg.eigh(covariance(x))
    buckets = bucket_eigenvalues(eigenvalues, n_subquantizers)
    flat = [i for bucket in buckets for i in bucket]
    return np.ascontiguousarray(eigenvectors[:, flat])


def quantize_batch(codebooks: np.ndarray, x: np.ndarray) -> np.ndarray:
    """primitives.rs:64-104: sequential per-subquantizer assignment."""
    m, k, ds = codebooks.shape
    n = x.shape[0]
    codes = np.empty((n, m), dtype=np.int64)
    for sq in range(m):
        codes[:, sq] = cluster_assignments(
            codebooks[sq], x[:, sq * ds : (sq + 1) * ds]
        )
    return codes


def reconstruct_batch(codebooks: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """primitives.rs:110-173: pure gather + concat."""
    m, k, ds = codebooks.shape
    n = codes.shape[0]
    out = np.empty((n, m * ds), dtype=codebooks.dtype)
    for sq in range(m):
        out[:, sq * ds : (sq + 1) * ds] = codebooks[sq][codes[:, sq]]
    return out


def train_opq(
    x: np.ndarray,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    master: ChaCha8Rng,
) -> tuple:
    """opq.rs:40-100: returns ``(projection, codebooks)``.  The master RNG
    is consumed directly (no XorShift forks), one subquantizer after
    another, drawing initial centroids from the ROTATED data."""
    n, d = x.shape
    m = n_subquantizers
    k = 2 ** n_subquantizer_bits
    ds = d // m
    projection = create_projection_matrix(x, m).astype(x.dtype)
    rx = x @ projection
    codebooks = np.empty((m, k, ds), dtype=x.dtype)
    for sq in range(m):
        idx = distinct_indices(master, n, k)
        codebooks[sq] = rx[idx, sq * ds : (sq + 1) * ds]

    for _ in range(n_iterations):
        # opq.rs:161-189: rotate, one k-means step per subquantizer,
        # quantize/reconstruct roundtrip, Procrustes projection update.
        rx = x @ projection
        for sq in range(m):
            sq_x = rx[:, sq * ds : (sq + 1) * ds]
            assignments = cluster_assignments(codebooks[sq], sq_x)
            update_centroids(codebooks[sq], sq_x, assignments)
        codes = quantize_batch(codebooks, rx)
        reconstructed = reconstruct_batch(codebooks, codes)
        u, _, vt = np.linalg.svd(x.T @ reconstructed)
        projection = (u @ vt).astype(x.dtype)

    return projection, codebooks


def train_gaussian_opq(
    x: np.ndarray,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int,
    master: ChaCha8Rng,
) -> tuple:
    """gaussian_opq.rs:27-69: closed-form projection once, then plain PQ
    training on the rotated data with the same master."""
    projection = create_projection_matrix(x, n_subquantizers).astype(x.dtype)
    rx = x @ projection
    codebooks = train_pq(
        rx, n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts,
        master,
    )
    return projection, codebooks


def avg_euclidean_loss(
    x: np.ndarray, codebooks: np.ndarray, projection=None
) -> float:
    """The reference tests' quality metric (pq.rs:365-376): mean Euclidean
    distance between rows and their quantize->reconstruct roundtrip."""
    rx = x if projection is None else x @ projection
    rec = reconstruct_batch(codebooks, quantize_batch(codebooks, rx))
    if projection is not None:
        rec = rec @ projection.T
    return float(np.mean(np.sqrt(np.sum((x - rec) ** 2, axis=1))))


def adc_distances(
    codebooks: np.ndarray, queries: np.ndarray, codes: np.ndarray, metric: str
) -> np.ndarray:
    """``(nq, n)`` ADC scores as distances to the reconstructions:
    squared Euclidean for ``"l2"``, negated inner product for ``"dot"``
    (the library's ascending-is-best convention)."""
    rec = reconstruct_batch(codebooks, codes)
    if metric == "dot":
        return -(queries.astype(np.float64) @ rec.astype(np.float64).T)
    return squared_euclidean_distance(
        queries.astype(np.float64), rec.astype(np.float64)
    )

"""K-means clustering as a single jittable tensor program.

Counterpart of the reference's clustering engine (reference:
``src/kmeans.rs``).  Where the reference interleaves BLAS matmuls with
scalar argmin loops and scatter-adds on the host, every step here is a
dense tensor op that XLA compiles for the device:

* **assign** — pairwise squared distances via the norm expansion (one
  matmul) followed by a vectorized argmin (reference:
  ``src/kmeans.rs:111-159``).
* **update** — the scatter-add over assignments (reference:
  ``src/kmeans.rs:166-198``) becomes a one-hot matmul
  ``onehot(codes)^T @ x``, i.e. another matmul, plus a count-guarded
  divide.  Clusters with zero assigned points get the **zero vector**,
  exactly matching the reference's zero-fill + guarded-divide semantics.
* **iterate** — ``lax.fori_loop`` / ``lax.while_loop`` drivers replace the
  host-side iteration; the whole Lloyd's loop stays on device under one
  ``jit``.

Semantics preserved bit-for-bit where it matters for parity:

* argmin tie-break: first index wins (``jnp.argmin`` semantics match the
  reference's ``min_by_key`` over enumerated distances,
  ``src/kmeans.rs:119-125``).
* the per-iteration loss is the MSE between instances and their assigned
  centroids **after** the centroid update, normalized by ``n * d`` — the
  total number of scalar elements, not the number of instances
  (reference: ``src/kmeans.rs:319-327,359``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import Array

from .linalg import squared_euclidean_distance

__all__ = [
    "RandomInstanceCentroids",
    "KMeansPlusPlusCentroids",
    "NIterations",
    "LossConvergence",
    "cluster_assignment",
    "cluster_assignments",
    "update_centroids",
    "mean_squared_error",
    "kmeans_iteration",
    "kmeans_with_centroids",
    "kmeans_with_centroids_chunked",
    "kmeans",
]


# ---------------------------------------------------------------------------
# Initial centroid selection (reference: src/kmeans.rs:17-88)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n", "k"))
def random_distinct_indices(key: Array, n: int, k: int) -> Array:
    """``k`` distinct uniform indices in ``[0, n)``, in first-draw order.

    Jitted at module level: the draw is ~a dozen small ops that compile
    to a single program instead of a dozen eager dispatches (nested jit
    calls inline, so in-jit callers are unaffected).

    Matches the reference's draw-until-k-distinct semantics
    (``src/kmeans.rs:73-79``) without the O(n log n) full permutation that
    ``jax.random.choice(replace=False)`` performs — at n = 8M that
    permutation dominated training startup.  For ``n > 16k`` an
    oversampled batch of ``4k`` draws is deduplicated in first-occurrence
    order via a stable sort (O(c log c) — a pairwise-equality matrix would
    be O(c^2), ~64 GB at the supported k = 65536); small ``n`` keeps the
    exact permutation path.

    The probability of fewer than ``k`` distinct values among ``4k`` draws
    at ``n > 16k`` is astronomically small; if it ever happens, unfilled
    output slots fall back to the identity indices ``0..k`` (valid, mostly
    distinct) rather than silently duplicating index 0.
    """
    if n <= 16 * k:
        return jax.random.choice(key, n, shape=(k,), replace=False)
    c = 4 * k
    cand = jax.random.randint(key, (c,), 0, n)
    # Stable sort groups equal values with draw order preserved inside each
    # run, so the first element of a run is the earliest draw of that value.
    perm = jnp.argsort(cand, stable=True)
    sorted_vals = jnp.take(cand, perm)
    is_first_sorted = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_vals[1:] != sorted_vals[:-1]]
    )
    first = jnp.zeros((c,), bool).at[perm].set(is_first_sorted)
    # Select the first k first-occurrences in draw order.
    rank = jnp.cumsum(first) - 1  # rank among distinct values
    slot = jnp.where(first & (rank < k), rank, k)
    return jnp.arange(k, dtype=cand.dtype).at[slot].set(cand, mode="drop")


@dataclasses.dataclass(frozen=True)
class RandomInstanceCentroids:
    """Pick ``k`` distinct random instances as the initial centroids.

    Counterpart of the reference's ``RandomInstanceCentroids``
    (``src/kmeans.rs:35-88``), which draws uniform indices into a hash set
    until ``k`` distinct ones are found.  Here the same distribution over
    distinct index sets comes from ``jax.random.choice`` without
    replacement, which stays on device and is deterministic per key.
    """

    def __call__(self, key: Array, x: Array, k: int) -> Array:
        n = x.shape[0]
        if k <= 0:
            raise ValueError("Cannot pick 0 random centroids")
        if k >= n:
            raise ValueError(
                f"Cannot pick more centroids than instances: {n} instances, {k} centroids"
            )
        if x.ndim != 2 or x.shape[1] == 0:
            raise ValueError("Cannot pick centroids from zero-length instances")
        indices = jax.random.choice(key, n, shape=(k,), replace=False)
        return jnp.take(x, indices, axis=0)


@dataclasses.dataclass(frozen=True)
class KMeansPlusPlusCentroids:
    """k-means++ (Arthur & Vassilvitskii, 2007) D²-weighted seeding.

    A capability extension over the reference (which only ships random
    instance seeding): successive centroids are sampled with probability
    proportional to the squared distance to the nearest centroid chosen so
    far.  Runs as a ``fori_loop`` so the whole seeding is one compiled
    program.

    For large ``k`` the strictly sequential draw is slow on any
    accelerator — 4096 centroids means 4096 dependent steps of small
    vector work.  ``batch > 1``
    switches to round-based D²-weighted sampling (the k-means|| idea,
    Bahmani et al., 2012): each round draws ``batch`` distinct candidates
    from the *current* D² distribution at once, then updates the
    distances with one ``(n, batch)`` distance matmul.  Candidates
    within a round don't see each other's D² updates — the standard
    oversampling trade, empirically indistinguishable after Lloyd's
    refinement.  The default picks ``batch`` so there are at most ~64
    rounds, and stays exactly sequential (``batch=1``) for small ``k``.
    """

    def __call__(
        self, key: Array, x: Array, k: int, batch: Optional[int] = None
    ) -> Array:
        n, d = x.shape
        if k <= 0:
            raise ValueError("Cannot pick 0 random centroids")
        if k >= n:
            raise ValueError(
                f"Cannot pick more centroids than instances: {n} instances, {k} centroids"
            )
        if batch is None:
            # <= 256 rounds: at 4096 cells, 64-wide rounds measurably
            # skewed cell balance vs sequential seeding (370k of 10M rows
            # overflowed their 4 nearest auto-capacity IVF cells vs ~0);
            # 16-wide rounds restore balance at ~256 cheap fused steps.
            batch = max(1, -(-(k - 1) // 256))
        rounds = -(-(k - 1) // batch)
        kp = 1 + rounds * batch  # padded; extras are discarded at the end
        key, first = jax.random.split(key)
        first_idx = jax.random.randint(first, (), 0, n)
        centroids = jnp.zeros((kp, d), x.dtype).at[0].set(x[first_idx])
        min_d2 = squared_euclidean_distance(x, x[first_idx][None, :])[:, 0]

        def body(r, carry):
            centroids, min_d2, key = carry
            key, sub = jax.random.split(key)
            weights = jnp.maximum(min_d2, 0.0)
            # Degenerate case (all points identical): fall back to uniform.
            total = jnp.sum(weights)
            probs = jnp.where(total > 0, weights / jnp.maximum(total, 1e-30), 1.0 / n)
            # replace=False: a round never returns the same instance twice
            # (a duplicate centroid would stay a dead cell through Lloyd's).
            idx = jax.random.choice(sub, n, shape=(batch,), p=probs,
                                    replace=False)
            chosen = jnp.take(x, idx, axis=0)
            centroids = jax.lax.dynamic_update_slice(
                centroids, chosen, (1 + r * batch, 0)
            )
            d2 = squared_euclidean_distance(x, chosen)  # (n, batch)
            return centroids, jnp.minimum(min_d2, jnp.min(d2, axis=1)), key

        centroids, _, _ = jax.lax.fori_loop(
            0, rounds, body, (centroids, min_d2, key)
        )
        return centroids[:k]


# ---------------------------------------------------------------------------
# Stop conditions (reference: src/kmeans.rs:91-104)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NIterations:
    """Stop after exactly ``n`` iterations (reference:
    ``NIterationsCondition``, ``src/kmeans.rs:97-104``).  Lowered to a
    ``lax.fori_loop`` — no data-dependent control flow."""

    n: int


@dataclasses.dataclass(frozen=True)
class LossConvergence:
    """Stop when the relative loss improvement drops below ``rel_tol``, or
    after ``max_iterations`` — a capability extension made practical on the
    device by ``lax.while_loop`` (the reference's ``StopCondition`` trait is
    pluggable but only ships a fixed-iteration impl)."""

    max_iterations: int
    rel_tol: float = 1e-6


StopCondition = NIterations | LossConvergence


# ---------------------------------------------------------------------------
# Core steps
# ---------------------------------------------------------------------------


def cluster_assignment(centroids: Array, instance: Array) -> Array:
    """Index of the nearest centroid for one instance (reference:
    ``src/kmeans.rs:111-126``).  Ties break to the first index."""
    dists = squared_euclidean_distance(instance, centroids)
    return jnp.argmin(dists).astype(jnp.int32)


def cluster_assignments(centroids: Array, instances: Array) -> Array:
    """Nearest-centroid index for each row of ``instances`` (reference:
    ``src/kmeans.rs:133-159``).  One ``(n, d) x (d, k)`` matmul plus a row
    argmin; ties break to the first index."""
    dists = squared_euclidean_distance(instances, centroids)
    return jnp.argmin(dists, axis=1).astype(jnp.int32)


def update_centroids(x: Array, assignments: Array, k: int) -> Array:
    """Mean of the instances assigned to each centroid.

    Functional counterpart of the reference's in-place scatter-add update
    (``src/kmeans.rs:166-198``), recast as a one-hot matmul so the
    reduction is a matmul.  Clusters with no assigned instances become
    the **zero vector**, matching the reference's zero-fill +
    divide-only-if-count-positive semantics (``src/kmeans.rs:181,194-196``).
    """
    onehot = jax.nn.one_hot(assignments, k, dtype=x.dtype)  # (n, k)
    # f32 accumulation: bf16 matmul inputs would corrupt the per-cluster sums.
    sums = jnp.dot(onehot.T, x, precision="highest")  # (k, d)
    counts = jnp.sum(onehot, axis=0)  # (k,)
    safe = jnp.maximum(counts, 1.0)
    return jnp.where((counts > 0)[:, None], sums / safe[:, None], 0.0).astype(x.dtype)


def mean_squared_error(centroids: Array, x: Array, assignments: Array) -> Array:
    """MSE between instances and their assigned centroids, normalized by the
    total element count ``n * d`` (reference: ``src/kmeans.rs:330-360`` —
    note the division by ``instances.len()``, which in ndarray is the number
    of scalars, not rows)."""
    assigned = jnp.take(centroids, assignments, axis=0)
    err = assigned - x
    sse = jnp.sum(err * err)
    return sse / jnp.asarray(x.size, dtype=x.dtype)


def kmeans_iteration(
    x: Array, centroids: Array, instance_axis: int = 0
) -> Tuple[Array, Array]:
    """One Lloyd's step: assign → update → loss (reference:
    ``src/kmeans.rs:291-328``).  Returns the new centroids and the MSE of
    the instances against the **updated** centroids under the assignments
    computed from the old centroids — the reference's exact loss
    definition.  ``instance_axis`` selects rows (0) or columns (1) as
    instances, mirroring the reference's ``Axis`` parameter; centroids
    are always rows.

    The one-hot assignment matrix is built once and drives both the
    centroid update and the loss: selecting assigned centroids as
    ``onehot @ centroids`` (a single-nonzero-per-row matmul at
    ``precision="highest"`` — bit-exact) reuses the matrix the update
    already built instead of a second gather.
    """
    x = _instances_as_rows(x, instance_axis)
    k = centroids.shape[0]
    if k == 0:
        raise ValueError("Cannot cluster instances with zero centroids.")
    assignments = cluster_assignments(centroids, x)
    onehot = jax.nn.one_hot(assignments, k, dtype=x.dtype)  # (n, k)
    sums = jnp.dot(onehot.T, x, precision="highest")
    counts = jnp.sum(onehot, axis=0)
    safe = jnp.maximum(counts, 1.0)
    new_centroids = jnp.where(
        (counts > 0)[:, None], sums / safe[:, None], 0.0
    ).astype(x.dtype)
    assigned = jnp.dot(onehot, new_centroids, precision="highest")
    err = assigned - x
    loss = jnp.sum(err * err) / jnp.asarray(x.size, dtype=x.dtype)
    return new_centroids, loss


def _instances_as_rows(x: Array, instance_axis: int) -> Array:
    """Normalize the reference's ``Axis`` parameter: instances as rows."""
    if instance_axis == 1:
        return x.T
    if instance_axis != 0:
        raise ValueError(f"instance_axis must be 0 or 1, got {instance_axis}")
    return x


def kmeans_with_centroids(
    x: Array,
    centroids: Array,
    stop: StopCondition | int,
    instance_axis: int = 0,
) -> Tuple[Array, Array]:
    """Run Lloyd's iterations from the given initial centroids (reference:
    ``KMeansWithCentroids``, ``src/kmeans.rs:248-288``).

    ``stop`` may be an int (shorthand for :class:`NIterations`), an
    :class:`NIterations`, or a :class:`LossConvergence`; ``instance_axis``
    mirrors the reference's ``Axis`` parameter.  Returns
    ``(centroids, final_loss)``.
    """
    x = _instances_as_rows(x, instance_axis)
    if isinstance(stop, int):
        stop = NIterations(stop)
    if centroids.shape[0] == 0:
        raise ValueError("Cannot cluster instances with zero centroids.")
    if centroids.shape[1] != x.shape[1]:
        raise ValueError(
            f"Centroid and instance lengths differ: {centroids.shape[1]} != {x.shape[1]}"
        )

    if isinstance(stop, NIterations):
        # stop.n may be a traced value (dynamic iteration count — one
        # compilation serves all counts); validate only when concrete.
        if isinstance(stop.n, int) and stop.n <= 0:
            raise ValueError("The number of iterations must be >= 1")

        def body(_, carry):
            centroids, _ = carry
            return kmeans_iteration(x, centroids)

        init_loss = jnp.asarray(jnp.inf, dtype=x.dtype)
        return jax.lax.fori_loop(0, stop.n, body, (centroids, init_loss))

    if isinstance(stop, LossConvergence):
        max_iter = stop.max_iterations
        rel_tol = stop.rel_tol

        def cond(carry):
            i, _, loss, prev_loss = carry
            improved = (prev_loss - loss) > rel_tol * jnp.maximum(prev_loss, 1e-30)
            return jnp.logical_and(i < max_iter, jnp.logical_or(i < 1, improved))

        def body(carry):
            i, centroids, loss, _ = carry
            new_centroids, new_loss = kmeans_iteration(x, centroids)
            return i + 1, new_centroids, new_loss, loss

        init = (
            jnp.asarray(0, jnp.int32),
            centroids,
            jnp.asarray(jnp.inf, x.dtype),
            jnp.asarray(jnp.inf, x.dtype),
        )
        _, centroids, loss, _ = jax.lax.while_loop(cond, body, init)
        return centroids, loss

    raise TypeError(f"Unsupported stop condition: {stop!r}")


def kmeans_with_centroids_chunked(
    x: Array,
    centroids: Array,
    n_iterations: int,
    *,
    chunk: int = 32768,
    use_kernel: Optional[bool] = None,
) -> Tuple[Array, Array]:
    """Corpus-scale Lloyd's from given initial centroids: streams ``x``
    so the ``(n, k)`` distance matrix never materializes (40 GB at
    n=10M, k=1024).  A single-quantizer view of the PQ machinery
    (:func:`reductive_tpu.pq.train.lloyd_iteration_chunked` with
    ``m = 1``; ``use_kernel`` as resolved by
    :func:`reductive_tpu.dispatch.use_kernel`).  Same semantics as
    :func:`kmeans_with_centroids` with :class:`NIterations`; empty
    clusters become the zero vector; the returned loss is the MSE against
    the updated centroids normalized by ``n * d``
    (reference: ``src/kmeans.rs:248-328``)."""
    from .dispatch import use_kernel as choose
    from .pq.train import lloyd_iteration_chunked

    if centroids.shape[0] == 0:
        raise ValueError("Cannot cluster instances with zero centroids.")
    if centroids.shape[1] != x.shape[1]:
        raise ValueError(
            f"Centroid and instance lengths differ: {centroids.shape[1]} != {x.shape[1]}"
        )
    if isinstance(n_iterations, int) and n_iterations <= 0:
        raise ValueError("The number of iterations must be >= 1")
    use_kernel = choose("encode", use_kernel)
    sumsq = jnp.sum(x.astype(jnp.float32) ** 2, dtype=jnp.float32)[None]

    def body(_, carry):
        c, _ = carry
        cb, losses = lloyd_iteration_chunked(
            x, c[None, :, :], sumsq, chunk=chunk, use_kernel=use_kernel,
        )
        return cb[0], losses[0]

    init = (centroids, jnp.asarray(jnp.inf, jnp.float32))
    return jax.lax.fori_loop(0, n_iterations, body, init)


def kmeans(
    key: Array,
    x: Array,
    k: int,
    stop: StopCondition | int,
    init: Callable[[Array, Array, int], Array] = RandomInstanceCentroids(),
    instance_axis: int = 0,
) -> Tuple[Array, Array]:
    """Full k-means: initial centroid selection followed by Lloyd's
    iterations (reference: ``KMeans::k_means``, ``src/kmeans.rs:201-240``).

    ``instance_axis`` selects whether instances are rows (0) or columns (1)
    of ``x``, mirroring the reference's ``Axis`` parameter; centroids are
    always returned as rows.
    """
    x = _instances_as_rows(x, instance_axis)
    n = x.shape[0]
    if k == 0 or k > n:
        raise ValueError("k cannot be larger than the number of data points or zero")
    centroids = init(key, x, k)
    return kmeans_with_centroids(x, centroids, stop)

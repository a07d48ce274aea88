"""Sharded k-means and PQ training/encode over a device mesh.

What the reference cannot do: its training is bounded by one machine's RAM
and one rayon pool (SURVEY.md §2, "Parallelism inventory").  Here Lloyd's
iteration becomes an SPMD program:

* instances ``(n, d)`` sharded along ``n`` over the ``data`` mesh axis;
* codebooks ``(m, k, ds)`` replicated over ``data`` and (optionally)
  sharded along ``m`` over the ``model`` axis — the ``m`` subquantizer
  trainings are independent, so model parallelism costs zero
  communication;
* the centroid update's one-hot sums and counts are **psum**-reduced over
  ``data`` (over NVLink between the cards of a host), after which the count-guarded
  divide happens replicated — numerically identical to the single-device
  path, so all golden tests transfer.

Two API styles are provided:

* :func:`train_pq_sharded` / :func:`encode_sharded` — GSPMD style: the
  exact single-device programs jitted with sharding annotations; XLA
  inserts the collectives.
* :func:`sharded_kmeans` / :func:`sharded_pq_train_step` — explicit
  ``shard_map`` + ``psum`` versions, used where collective placement must
  be exact (and as the multi-device dry-run entry).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import Array
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..errors import check_quantizer_invariants
from ..pq.model import Pq
from ..pq.train import _train_codebooks

__all__ = [
    "sharded_kmeans",
    "sharded_pq_train_step",
    "train_pq_sharded",
    "train_pq_chunked_sharded",
    "train_opq_chunked_sharded",
    "train_pq_streamed_sharded",
    "encode_sharded",
    "stream_encode_sharded",
]


# ---------------------------------------------------------------------------
# Explicit shard_map + psum building blocks
# ---------------------------------------------------------------------------


def _local_stats(x: Array, centroids: Array) -> Tuple[Array, Array, Array]:
    """Per-shard assign + partial statistics for one Lloyd's step.

    Returns (sums (k, d), counts (k,), sse scalar-parts) computed from the
    local instance shard only.  The caller psums these over the data axis.
    """
    from ..linalg import squared_euclidean_distance

    dists = squared_euclidean_distance(x, centroids)
    assignments = jnp.argmin(dists, axis=1).astype(jnp.int32)
    onehot = jax.nn.one_hot(assignments, centroids.shape[0], dtype=x.dtype)
    sums = jnp.dot(onehot.T, x, precision="highest")
    counts = jnp.sum(onehot, axis=0)
    return sums, counts, assignments


def _finish_update(sums: Array, counts: Array, dtype) -> Array:
    """Count-guarded divide; empty clusters become the zero vector
    (reference semantics: ``src/kmeans.rs:181,194-196``)."""
    safe = jnp.maximum(counts, 1.0)
    return jnp.where((counts > 0)[:, None], sums / safe[:, None], 0.0).astype(dtype)


def sharded_kmeans_iteration(x_local: Array, centroids: Array, data_axis: str):
    """One data-parallel Lloyd's iteration (call inside ``shard_map``).

    ``x_local`` is this device's ``(n_local, d)`` shard; ``centroids`` is
    replicated.  Statistics are psum-reduced over ``data_axis``; the
    returned centroids and loss are replicated and identical to the
    single-device :func:`reductive_tpu.kmeans.kmeans_iteration`.
    """
    sums, counts, assignments = _local_stats(x_local, centroids)
    sums = jax.lax.psum(sums, data_axis)
    counts = jax.lax.psum(counts, data_axis)
    new_centroids = _finish_update(sums, counts, x_local.dtype)

    assigned = jnp.take(new_centroids, assignments, axis=0)
    local_sse = jnp.sum((assigned - x_local) ** 2)
    sse = jax.lax.psum(local_sse, data_axis)
    n_total = jax.lax.psum(jnp.asarray(x_local.size, x_local.dtype), data_axis)
    return new_centroids, sse / n_total


def sharded_kmeans(
    mesh: Mesh,
    x: Array,
    centroids: Array,
    n_iterations: int,
    data_axis: str = "data",
) -> Tuple[Array, Array]:
    """Data-parallel Lloyd's from given initial centroids.

    Instances shard along ``n`` over ``data_axis``; centroids replicate.
    Numerically identical to the single-device path (the psum'd sums and
    counts match the global one-hot matmul).
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(data_axis, None), P()),
        out_specs=(P(), P()),
    )
    def run(x_local, centroids):
        def body(_, carry):
            c, _ = carry
            return sharded_kmeans_iteration(x_local, c, data_axis)

        init = (centroids, jnp.asarray(jnp.inf, x_local.dtype))
        return jax.lax.fori_loop(0, n_iterations, body, init)

    return jax.jit(run)(x, centroids)


def sharded_pq_train_step(
    xs: Array, codebooks: Array, data_axis: str = "data", model_axis: str = "model"
) -> Tuple[Array, Array]:
    """One full PQ training step over a 2-D (data x model) mesh — the
    multi-device dry-run entry (call inside ``shard_map``).

    ``xs`` is the local ``(n_local, m_local, ds)`` shard: instances split
    over ``data_axis``, subquantizers split over ``model_axis``.
    ``codebooks`` is the local ``(m_local, k, ds)`` shard.  Per
    subquantizer: assign, psum statistics over data, update.  No
    communication crosses the model axis (subquantizers are independent);
    the returned loss is psum'd over both axes to a global scalar.
    """

    def one_subquantizer(x_sq, cb):
        sums, counts, assignments = _local_stats(x_sq, cb)
        sums = jax.lax.psum(sums, data_axis)
        counts = jax.lax.psum(counts, data_axis)
        new_cb = _finish_update(sums, counts, x_sq.dtype)
        assigned = jnp.take(new_cb, assignments, axis=0)
        return new_cb, jnp.sum((assigned - x_sq) ** 2)

    xs_m = jnp.moveaxis(xs, 1, 0)  # (m_local, n_local, ds)
    new_codebooks, sse = jax.vmap(one_subquantizer)(xs_m, codebooks)
    total_sse = jax.lax.psum(jax.lax.psum(jnp.sum(sse), data_axis), model_axis)
    total_elems = jax.lax.psum(
        jax.lax.psum(jnp.asarray(xs.size, xs.dtype), data_axis), model_axis
    )
    return new_codebooks, total_sse / total_elems


# ---------------------------------------------------------------------------
# Corpus-scale data-parallel training: per-shard statistics + psum
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("m", "k"))
def _init_sharded_codebooks(x, key, *, m: int, k: int, projection=None):
    """k distinct random instances per subquantizer from the (sharded)
    global instance matrix, rotated (rows only) when a projection is
    given; XLA gathers across shards.  Module-level jit — the compile
    cache survives across training calls."""
    from ..pq.train import init_codebooks_random

    ds = x.shape[1] // m
    keys = jax.random.split(key, m)
    return init_codebooks_random(x, keys, k, ds, projection)


@functools.lru_cache(maxsize=None)
def _chunked_sharded_step(
    mesh: Mesh, data_axis: str, chunk: int, use_kernel: bool,
    has_projection: bool = False,
):
    """Build (and cache) the jitted sharded chunked training loop for a
    mesh/config.  Each device accumulates assignment statistics over its
    local instance shard; only the tiny ``(m, k, ds)`` sums and ``(m, k)``
    counts cross devices per iteration (psum) — 0.147 MB at the flagship
    shape, independent of the corpus size."""
    from ..pq.train import (
        assign_stats_streamed,
        centroids_from_stats,
        losses_from_stats,
    )

    n_shards = 1
    for ax in ([data_axis] if isinstance(data_axis, str) else data_axis):
        n_shards *= mesh.shape[ax]

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(data_axis, None), P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(x_local, codebooks, sumsq, n_iterations, projection):
        n_local, d = x_local.shape
        m, k, ds = codebooks.shape
        n_total = n_local * n_shards

        def body(_, carry):
            cb, _ = carry
            sums, counts = assign_stats_streamed(
                x_local, cb, chunk=chunk, use_kernel=use_kernel,
                projection=projection if has_projection else None,
            )
            sums = jax.lax.psum(sums, data_axis)
            counts = jax.lax.psum(counts, data_axis)
            new_cb = centroids_from_stats(sums, counts, x_local.dtype)
            losses = losses_from_stats(sums, counts, sumsq, n_total * ds)
            return new_cb, losses

        init = (codebooks, jnp.full((m,), jnp.inf, jnp.float32))
        return jax.lax.fori_loop(0, n_iterations, body, init)

    return run


def train_pq_chunked_sharded(
    key: Array,
    instances: Array,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    mesh: Mesh,
    data_axis: str = "data",
    chunk: int = 32768,
    use_kernel: Optional[bool] = None,
    projection=None,
) -> Pq:
    """Corpus-scale data-parallel PQ training: instances sharded along
    ``n`` over ``data_axis``, each shard swept by
    :func:`reductive_tpu.pq.train.assign_stats_streamed`, centroid
    statistics psum-reduced across devices, the count-guarded divide and
    loss replicated.  Numerically equivalent to
    :func:`reductive_tpu.pq.train.train_pq_chunked` on the gathered data
    (up to f32 summation order of the per-shard partial sums).

    With ``projection`` (orthonormal ``(d, d)``), shards are rotated
    chunk-by-chunk on the fly and the returned model carries the
    projection — the sharded GaussianOpq composition
    (``create_projection_matrix`` + this).

    ``n`` must be divisible by the ``data_axis`` size.  ``use_kernel``
    is resolved by :func:`reductive_tpu.dispatch.use_kernel`.
    """
    n, d = instances.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    m = n_subquantizers
    k = 2 ** n_subquantizer_bits
    ds = d // m
    if n % mesh.shape[data_axis] != 0:
        raise ValueError(
            f"n={n} must divide evenly over data axis "
            f"({mesh.shape[data_axis]} shards)"
        )

    from ..dispatch import use_kernel as choose

    use_kernel = choose("encode", use_kernel)
    x = jax.device_put(instances, NamedSharding(mesh, P(data_axis, None)))
    # sumsq of the (rotated) data; rotation is fused into the reduction
    # under one jit — the rotated corpus is never held live (the training
    # loop rotates chunks on the fly, and codebook init rotates only the
    # k sampled rows).
    from ..pq.train import _streamed_sumsq

    sumsq = _streamed_sumsq(x, m, chunk=chunk, projection=projection)

    step = _chunked_sharded_step(
        mesh, data_axis, chunk, use_kernel, projection is not None,
    )
    proj_arg = projection if projection is not None else jnp.zeros((d, d), x.dtype)

    best_cb, best_loss = None, None
    for attempt in range(n_attempts):
        codebooks = _init_sharded_codebooks(
            x, jax.random.fold_in(key, attempt), m=m, k=k, projection=projection
        )
        cb, loss = step(x, codebooks, sumsq, n_iterations, proj_arg)
        if best_cb is None:
            best_cb, best_loss = cb, loss
        else:
            better = loss < best_loss
            best_cb = jnp.where(better[:, None, None], cb, best_cb)
            best_loss = jnp.minimum(best_loss, loss)
    return Pq(codebooks=best_cb, projection=projection)


@functools.lru_cache(maxsize=None)
def _opq_sharded_step(mesh: Mesh, data_axis: str, chunk: int, use_kernel: bool):
    """Jitted data-parallel OPQ alternation loop: each device streams its
    instance shard, the centroid statistics and the Procrustes ``X^T
    X_hat`` cross-matrix are psum-reduced, and the SVD + updates run
    replicated."""
    from ..pq.opq import _opq_iteration_chunked

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(data_axis, None), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(x_local, projection, codebooks, n_iterations):
        def body(_, carry):
            proj, cb = carry
            proj, cb, _ = _opq_iteration_chunked(
                x_local, proj, cb, chunk=chunk, use_kernel=use_kernel,
                axis_name=data_axis,
            )
            return proj, cb

        return jax.lax.fori_loop(0, n_iterations, body, (projection, codebooks))

    return run


def train_opq_chunked_sharded(
    key: Array,
    instances: Array,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    mesh: Mesh,
    data_axis: str = "data",
    chunk: int = 32768,
    use_kernel: Optional[bool] = None,
) -> Pq:
    """Data-parallel corpus-scale OPQ: instances sharded along ``n``; per
    alternation each shard contributes psum'd centroid statistics (~2 MB)
    and a psum'd ``(d, d)`` Procrustes cross-matrix.  ``n_attempts`` is
    ignored exactly as in the reference (``src/pq/opq.rs:35-37,50``)."""
    from ..pq.opq import _init_opq_codebooks, create_projection_matrix

    n, d = instances.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, 1, n, d
    )
    k = 2 ** n_subquantizer_bits
    ds = d // n_subquantizers
    if n % mesh.shape[data_axis] != 0:
        raise ValueError(
            f"n={n} must divide evenly over data axis "
            f"({mesh.shape[data_axis]} shards)"
        )

    from ..dispatch import use_kernel as choose

    use_kernel = choose("encode", use_kernel)
    x = jax.device_put(instances, NamedSharding(mesh, P(data_axis, None)))
    # Covariance + eigh are GSPMD over the sharded instances; the greedy
    # bucketing is host-side on the d eigenvalues (tiny, once).
    projection = create_projection_matrix(x, n_subquantizers)
    keys = jax.random.split(key, n_subquantizers)
    codebooks = _init_opq_codebooks(x, keys, projection, k, ds)

    step = _opq_sharded_step(mesh, data_axis, chunk, use_kernel)
    projection, codebooks = step(x, projection, codebooks, n_iterations)
    return Pq(codebooks=codebooks, projection=projection)


# ---------------------------------------------------------------------------
# Multi-host streamed composition: >HBM corpora over a data-axis mesh.
#
# The single-host streamed trainers (reductive_tpu/pq/streamed.py) re-read
# the corpus from disk once per Lloyd's iteration.  On a cluster the corpus is
# also sharded across HOSTS: host h streams rows [h*n/H, (h+1)*n/H) of the
# corpus file (in a real multi-process job each process feeds its slice of
# the global batch via jax.make_array_from_process_local_data; in the
# single-controller setting below the controller reads every slice and
# lays the stacked (H, b, d) batch out over the data axis — the SPMD
# program is identical).  Per-shard statistics accumulate device-locally;
# the ONLY cross-device traffic is one (m, k, ds)+(m, k) psum per
# iteration (0.147 MB at the flagship shape), exactly like the in-HBM
# sharded trainer.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _streamed_sharded_step(
    mesh: Mesh, data_axis: str, use_kernel: bool, has_projection: bool,
):
    """Jitted per-batch accumulate: each device folds its local (1, b, d)
    slice of the global batch into its local (1, ...) accumulators via the
    same ``_stats_step`` the single-host streamed trainer uses.  No
    communication — the psum happens once per iteration in
    :func:`_streamed_sharded_reduce`."""
    from ..pq.streamed import _stats_step

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(data_axis), P(), P(), P(data_axis)),
        out_specs=P(data_axis),
        check_vma=False,
    )
    def run(acc_local, codebooks, projection, xb_local):
        s, c, q = _stats_step(
            jax.tree_util.tree_map(lambda a: a[0], acc_local),
            codebooks,
            projection if has_projection else None,
            xb_local[0],
            use_kernel=use_kernel,
        )
        return (s[None], c[None], q[None])

    return run


@functools.lru_cache(maxsize=None)
def _streamed_sharded_reduce(mesh: Mesh, data_axis: str):
    """psum the per-shard accumulators to replicated global statistics —
    the one collective of a streamed-sharded iteration."""

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(data_axis),
        out_specs=P(),
        check_vma=False,
    )
    def run(acc_local):
        return jax.tree_util.tree_map(
            lambda a: jax.lax.psum(a[0], data_axis), acc_local
        )

    return run


def train_pq_streamed_sharded(
    key: Array,
    reader,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    mesh: Mesh,
    data_axis: str = "data",
    batch_size: int = 1 << 18,
    use_kernel: Optional[bool] = None,
    projection: Optional[Array] = None,
    transfer_dtype=None,
    start: int = 0,
    stop: Optional[int] = None,
) -> Pq:
    """Multi-host streamed PQ training: a corpus larger than ANY host's
    memory, sharded by rows over the hosts of ``data_axis``, each host
    re-streaming only its ``n/H`` slice per Lloyd's iteration.

    The composition of :func:`reductive_tpu.pq.train_pq_streamed` (>HBM
    streaming, same ``_stats_step`` arithmetic, same initial-centroid
    draws — so results match the single-host streamed/chunked trainers up
    to f32 partial-sum grouping) with :func:`train_pq_chunked_sharded`'s
    communication structure (device-local statistics, one tiny psum per
    iteration).  ``projection`` rotates batches on the fly (the streamed
    GaussianOpq composition); ``transfer_dtype=jnp.bfloat16`` halves each
    host's wire bytes exactly as on the single-host path.

    ``reader`` rows must divide evenly over ``data_axis`` (pad the corpus
    file or trim the tail; a ragged final shard would change the compiled
    shapes per host).
    """
    from ..pq.streamed import _init_streamed_codebooks
    from ..dispatch import use_kernel as choose
    from ..pq.train import centroids_from_stats, losses_from_stats
    import numpy as np

    H = mesh.shape[data_axis]
    stop = reader.n if stop is None else min(stop, reader.n)
    n, d = stop - start, reader.dim
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    m, k = n_subquantizers, 2 ** n_subquantizer_bits
    ds = d // m
    use_kernel = choose("encode", use_kernel)
    if n % H != 0:
        raise ValueError(
            f"n={n} must divide evenly over data axis ({H} shards)"
        )
    per = n // H
    acc_sh = NamedSharding(mesh, P(data_axis))
    x_sh = NamedSharding(mesh, P(data_axis, None, None))
    proj_arg = (
        projection if projection is not None
        else jnp.zeros((d, d), jnp.float32)
    )
    step = _streamed_sharded_step(
        mesh, data_axis, use_kernel, projection is not None
    )
    reduce = _streamed_sharded_reduce(mesh, data_axis)

    def one_pass(cb):
        acc = (
            jax.device_put(np.zeros((H, m, k, ds), np.float32), acc_sh),
            jax.device_put(np.zeros((H, m, k), np.float32), acc_sh),
            jax.device_put(np.zeros((H, m), np.float32), acc_sh),
        )
        for off in range(0, per, batch_size):
            b = min(batch_size, per - off)
            # Controller-side stand-in for per-process local reads: on a
            # real multi-process job each process reads rows [start + h*per+off, +b)
            # itself.
            xb = np.stack(
                [np.asarray(reader.read(start + h * per + off, b))
                 for h in range(H)]
            )
            if transfer_dtype is not None:
                xb = xb.astype(transfer_dtype)
            xb = jax.device_put(xb, x_sh)
            acc = step(acc, cb, proj_arg, xb)
        return reduce(acc)

    best_cb, best_loss = None, None
    for attempt in range(n_attempts):
        akey = jax.random.fold_in(key, attempt)
        cb = _init_streamed_codebooks(
            akey, reader, m, k, ds, projection, start, stop
        )
        loss = jnp.full((m,), jnp.inf, jnp.float32)
        for it in range(n_iterations):
            sums, counts, sumsq = one_pass(cb)
            cb = centroids_from_stats(sums, counts, cb.dtype)
            loss = losses_from_stats(sums, counts, sumsq, n * ds)
        if best_cb is None:
            best_cb, best_loss = cb, loss
        else:
            better = loss < best_loss  # strict: ties keep earlier attempt
            best_cb = jnp.where(better[:, None, None], cb, best_cb)
            best_loss = jnp.minimum(best_loss, loss)
    return Pq(codebooks=best_cb, projection=projection)


@functools.lru_cache(maxsize=None)
def _stream_encode_sharded_step(
    mesh: Mesh, data_axis: str, dtype, use_kernel: bool, has_projection: bool
):
    from ..dispatch import encode

    def encode_one(codebooks, projection, x):
        x = x.astype(codebooks.dtype)
        if has_projection:
            x = jnp.dot(x, projection, precision="highest")
        return encode(codebooks, x, dtype=dtype, use_kernel=use_kernel)

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(data_axis)),
        out_specs=P(data_axis),
        check_vma=False,
    )
    def run(codebooks, projection, xb_local):
        return encode_one(codebooks, projection, xb_local[0])[None]

    return run


def stream_encode_sharded(
    pq: Pq,
    reader,
    *,
    mesh: Mesh,
    data_axis: str = "data",
    batch_size: int = 1 << 18,
    dtype=jnp.uint8,
    use_kernel: Optional[bool] = None,
    transfer_dtype=None,
) -> "np.ndarray":
    """Multi-host streamed encode: each host of ``data_axis`` streams its
    ``n/H`` row slice of the reader through the encode kernel; codes come
    back in corpus order.  Encode is embarrassingly parallel — zero
    collectives — and per-row arithmetic is identical to
    :func:`reductive_tpu.data.stream_encode`, so the emitted code matrix
    is **bit-equal** to the single-host stream at any shard count.
    ``n`` must divide evenly over ``data_axis``.
    """
    import numpy as np

    from ..dispatch import use_kernel as choose

    use_kernel = choose("encode", use_kernel)
    H = mesh.shape[data_axis]
    n, m = reader.n, pq.quantized_len
    if n % H != 0:
        raise ValueError(
            f"n={n} must divide evenly over data axis ({H} shards)"
        )
    per = n // H
    x_sh = NamedSharding(mesh, P(data_axis, None, None))
    d = reader.dim
    proj_arg = (
        pq.projection if pq.projection is not None
        else jnp.zeros((d, d), jnp.float32)
    )
    step = _stream_encode_sharded_step(
        mesh, data_axis, jnp.dtype(dtype), use_kernel,
        pq.projection is not None,
    )
    out = np.empty((n, m), dtype=np.dtype(dtype))
    for off in range(0, per, batch_size):
        b = min(batch_size, per - off)
        xb = np.stack(
            [np.asarray(reader.read(h * per + off, b)) for h in range(H)]
        )
        if transfer_dtype is not None:
            xb = xb.astype(transfer_dtype)
        codes = np.asarray(step(pq.codebooks, proj_arg, jax.device_put(xb, x_sh)))
        for h in range(H):
            out[h * per + off : h * per + off + b] = codes[h]
    return out


# ---------------------------------------------------------------------------
# GSPMD-style entries: same programs, sharding annotations
# ---------------------------------------------------------------------------


def train_pq_sharded(
    key: Array,
    instances: Array,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    mesh: Mesh,
    data_axis: str = "data",
) -> Pq:
    """Data-parallel :func:`reductive_tpu.pq.train.train_pq`.

    The instance tensor is placed sharded along ``n`` over ``data_axis``;
    the double-vmapped training program is reused unchanged — XLA
    partitions the distance matmuls row-wise and inserts all-reduces for
    the centroid statistics automatically (GSPMD).  Codebooks come out
    replicated.
    """
    n, d = instances.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    k = 2 ** n_subquantizer_bits
    ds = d // n_subquantizers
    xs = instances.reshape(n, n_subquantizers, ds)
    xs = jax.device_put(xs, NamedSharding(mesh, P(data_axis, None, None)))
    codebooks, _ = _train_codebooks(key, xs, k, n_iterations, n_attempts)
    return Pq(codebooks=codebooks, projection=None)


def encode_sharded(
    pq: Pq,
    x: Array,
    *,
    mesh: Mesh,
    data_axis: str = "data",
    dtype=jnp.uint8,
    use_kernel: Optional[bool] = None,
) -> Array:
    """Distributed batch encode: ``x`` sharded along ``n``, codebooks
    replicated, codes returned with the same row sharding.  Encode is
    embarrassingly parallel — zero collectives: each device encodes its
    local rows under ``shard_map`` with the encode kernel or the einsum
    (``use_kernel`` resolved by :func:`reductive_tpu.dispatch.use_kernel`).
    """
    from ..dispatch import use_kernel as choose

    use_kernel = choose("encode", use_kernel)
    x = jax.device_put(x, NamedSharding(mesh, P(data_axis, None)))
    return _encode_sharded_fn(mesh, data_axis, jnp.dtype(dtype), use_kernel)(pq, x)


@functools.lru_cache(maxsize=None)
def _encode_sharded_fn(mesh: Mesh, data_axis: str, dtype, use_kernel: bool):
    """Build (and cache) the jitted per-shard encode for a mesh/config —
    a fresh closure per call would re-trace and re-compile every time."""
    from ..dispatch import encode

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(data_axis, None)),
        out_specs=P(data_axis, None),
        check_vma=False,
    )
    def run(pq, x_local):
        if pq.projection is not None:
            x_local = jnp.dot(x_local, pq.projection, precision="highest")
        return encode(pq.codebooks, x_local, dtype=dtype, use_kernel=use_kernel)

    return run

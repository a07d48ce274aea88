"""ADC (asymmetric distance computation) search over PQ-encoded corpora.

The capability extension named by BASELINE.json config #5 ("multi-host
streaming encode + ADC search").  The reference itself ships no search —
retrieval lives downstream in finalfusion — but ADC is *the* standard use
of a product quantizer (Jégou et al., 2011, §IV): distances from a query
to millions of compressed vectors are computed from per-subquantizer
lookup tables without reconstructing anything.

Two scorers compute the per-vector table lookup ``sum_j T[j, codes[i, j]]``:
the GPU kernel (:func:`reductive_tpu.ops.adc.adc_scores_kernel`), which
gathers the table entries straight into an accumulator, and the plain
einsum scorer (:func:`adc_scores`), which restates the lookup as one
``(nq, k) x (k, chunk)`` one-hot matmul per subquantizer.
:func:`reductive_tpu.dispatch.use_kernel` picks between them.

All functions honor the quantizer's projection: queries are rotated into
codebook space first (codes were produced there too), and Euclidean
distances are preserved because the projection is orthonormal.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import Array

from .pq.model import Pq

__all__ = [
    "adc_tables", "adc_scores", "adc_scores_decode", "search",
    "search_sharded",
]

# search() auto-switches to the streamed scorer when the full (nq, n)
# score matrix would exceed this many f32 elements (64M = 256 MB) — a
# 10M-code corpus at 16 queries would otherwise silently materialize
# 640 MB of scores per call.
_STREAM_SCORE_ELEMS = 64 * (1 << 20)
_DEFAULT_STREAM_CHUNK = 1 << 20


def _resolve_stream_chunk(
    nq: int, n: int, stream_chunk: Optional[int], method: str = "einsum",
    d: int = 0,
) -> Optional[int]:
    """The effective streaming chunk: the caller's explicit choice, or the
    default chunk when the dense intermediates would be too large, or
    None (dense path) otherwise.  ``method="decode"`` additionally bounds
    the ``(n, d)`` f32 reconstruction it materializes."""
    if stream_chunk is not None:
        return stream_chunk
    # Bound the per-chunk (chunk, nq) score transient by the same 256 MB
    # budget that triggers streaming: a flat 1M-row chunk at nq=128 is
    # 512 MB of scores, doubled by top_k and by the scan's double
    # buffering.  The budget is a cap, not a rate.
    chunk = min(
        _DEFAULT_STREAM_CHUNK, max(1 << 16, _STREAM_SCORE_ELEMS // max(nq, 1))
    )
    if nq * n > _STREAM_SCORE_ELEMS:
        return min(chunk, n)
    if method == "decode" and n * d > _STREAM_SCORE_ELEMS:
        return min(chunk, n)
    return None


def adc_tables(
    pq: Pq, queries: Array, *, metric: str = "l2", precision="highest"
) -> Array:
    """Per-query lookup tables.

    Returns ``(nq, m, k)``.  With ``metric="l2"`` (default) entry
    ``[q, j, c]`` is the squared Euclidean distance between subvector
    ``j`` of (rotated) query ``q`` and centroid ``c`` of subquantizer
    ``j``; summed over ``j`` that is the exact squared distance to the
    reconstruction.  With ``metric="dot"`` the entry is the **negated**
    inner product ``-<q_j, c_c>`` — summing gives ``-<q, rec>``, so
    ascending score order ranks by *descending* inner product and every
    downstream top-k works unchanged (MIPS serving; for cosine,
    L2-normalize corpus and queries before encode/search and dot == cos).
    The orthonormal projection preserves inner products, so rotated-space
    tables are valid for both metrics.
    """
    if metric not in ("l2", "dot"):
        raise ValueError(f"unknown metric {metric!r} (expected 'l2' or 'dot')")
    if queries.ndim != 2:
        raise ValueError(f"queries must be (nq, d), got {queries.shape}")
    codebooks = pq.codebooks
    m, k, ds = codebooks.shape
    if queries.shape[1] != m * ds:
        raise ValueError(
            f"query length {queries.shape[1]} does not match quantizer "
            f"reconstructed length {m * ds}"
        )
    if pq.projection is not None:
        queries = jnp.dot(queries, pq.projection, precision=precision)
    qs = queries.reshape(-1, m, ds)
    cross = jnp.einsum("qmd,mkd->qmk", qs, codebooks, precision=precision)
    if metric == "dot":
        return -cross
    q_sqn = jnp.einsum("qmd,qmd->qm", qs, qs, precision=precision)
    c_sqn = jnp.einsum("mkd,mkd->mk", codebooks, codebooks, precision=precision)
    return q_sqn[:, :, None] + c_sqn[None, :, :] - (cross + cross)


def _chunk_scores(tables_flat: Array, codes_chunk: Array, k: int) -> Array:
    """Scores for one chunk of database codes.

    ``tables_flat`` is ``(nq, m*k)``; ``codes_chunk`` is ``(c, m)``.  One
    ``(nq, k) x (k, c)`` matmul per subquantizer against the one-hot of
    that subquantizer's code column — the transient one-hot is only
    ``(c, k)`` and the accumulation happens in f32.
    """
    c, m = codes_chunk.shape
    nq = tables_flat.shape[0]
    dtype = tables_flat.dtype
    scores = jnp.zeros((nq, c), dtype=dtype)
    for j in range(m):
        onehot = jax.nn.one_hot(codes_chunk[:, j].astype(jnp.int32), k, dtype=dtype)
        scores = scores + jnp.dot(
            tables_flat[:, j * k:(j + 1) * k], onehot.T, precision="highest"
        )
    return scores


def adc_scores_decode(
    pq: Pq, queries: Array, codes: Array, *, metric: str = "l2",
) -> Array:
    """``(nq, n)`` approximate squared distances via **decode + one dense
    matmul**: ``||q - rec||^2 = ||q||^2 + ||rec||^2 - 2 q.rec``.

    Cost model: the table scorers pay ``m`` lookups per (row, query);
    this path pays a one-off gather of ``d`` floats per row plus ``2 d``
    FLOPs per (row, query) — so it pays off only when the query batch is
    large, ``nq ≳ d`` (offline batch scoring, kNN-graph construction).
    The ``q.rec`` matmul runs at ``precision="highest"`` (f32, not TF32).
    """
    from .pq import primitives

    cb = pq.codebooks
    qr = (
        jnp.dot(queries, pq.projection, precision="highest")
        if pq.projection is not None
        else queries
    )
    rec = primitives.reconstruct_batch(cb, codes)  # rotated space
    qrec = jnp.dot(qr, rec.T, precision="highest",
                   preferred_element_type=jnp.float32)
    if metric == "dot":
        return -qrec
    rec_sqn = jnp.sum(rec.astype(jnp.float32) ** 2, axis=1)  # (n,)
    q_sqn = jnp.sum(qr.astype(jnp.float32) ** 2, axis=1)     # (nq,)
    return q_sqn[:, None] + rec_sqn[None, :] - 2.0 * qrec


def adc_scores(
    tables: Array, codes: Array, *, chunk_size: int = 16384
) -> Array:
    """Approximate squared distances from each query to each encoded vector.

    ``tables`` is ``(nq, m, k)`` from :func:`adc_tables`; ``codes`` is the
    ``(n, m)`` encoded corpus.  Returns ``(nq, n)``.  The corpus is
    processed in ``chunk_size`` blocks under ``lax.map`` so the transient
    one-hot stays bounded.
    """
    nq, m, k = tables.shape
    n = codes.shape[0]
    if codes.shape[1] != m:
        raise ValueError(f"codes have {codes.shape[1]} subquantizers, tables have {m}")
    tables_flat = tables.reshape(nq, m * k)

    if n <= chunk_size:
        return _chunk_scores(tables_flat, codes, k)

    n_chunks = n // chunk_size
    main = codes[: n_chunks * chunk_size].reshape(n_chunks, chunk_size, m)
    scores = jax.lax.map(
        lambda ch: _chunk_scores(tables_flat, ch, k), main
    )  # (n_chunks, nq, chunk)
    scores = jnp.moveaxis(scores, 0, 1).reshape(nq, n_chunks * chunk_size)
    rem = n - n_chunks * chunk_size
    if rem:
        tail = _chunk_scores(tables_flat, codes[n_chunks * chunk_size:], k)
        scores = jnp.concatenate([scores, tail], axis=1)
    return scores


@functools.partial(
    jax.jit,
    static_argnames=(
        "top_k", "chunk", "chunk_size", "method", "packed", "metric"
    ),
)
def _search_streamed_jit(
    pq: Pq, queries: Array, codes: Array, top_k: int, chunk: int,
    chunk_size: int, method: str, packed: bool = False, metric: str = "l2",
):
    """Top-k search without materializing the ``(nq, n)`` score matrix:
    a ``lax.scan`` over corpus chunks keeps only a running ``(nq, top_k)``
    best-so-far carry — O(nq * (chunk + top_k)) memory regardless of
    corpus size (6.4 GB of scores at 16 queries x 100M codes otherwise).
    """
    tables = (
        adc_tables(pq, queries, metric=metric) if method != "decode" else None
    )
    nq = queries.shape[0]
    n = codes.shape[0]

    def score(codes_chunk):
        return _score(pq, queries, tables, codes_chunk, chunk_size, method,
                      packed, metric)

    def merge(carry, chunk_scores, offset):
        best_negd, best_idx = carry
        negd, idx = jax.lax.top_k(-chunk_scores, min(top_k, chunk_scores.shape[1]))
        idx = idx + offset
        cat_negd = jnp.concatenate([best_negd, negd], axis=1)
        cat_idx = jnp.concatenate([best_idx, idx], axis=1)
        new_negd, sel = jax.lax.top_k(cat_negd, top_k)
        new_idx = jnp.take_along_axis(cat_idx, sel, axis=1)
        return new_negd, new_idx

    init = (
        jnp.full((nq, top_k), -jnp.inf, jnp.float32),
        jnp.zeros((nq, top_k), jnp.int32),
    )
    n_main = (n // chunk) * chunk
    carry = init
    if n_main:
        def body(carry, args):
            codes_chunk, offset = args
            return merge(carry, score(codes_chunk), offset), None

        carry, _ = jax.lax.scan(
            body,
            init,
            (
                codes[:n_main].reshape(-1, chunk, codes.shape[1]),
                jnp.arange(0, n_main, chunk, dtype=jnp.int32),
            ),
        )
    if n_main < n:
        carry = merge(carry, score(codes[n_main:]), jnp.int32(n_main))
    best_negd, best_idx = carry
    return -best_negd, best_idx


def _score(pq, queries, tables, codes, chunk_size, method, packed, metric):
    """``(nq, n)`` scores of one block of codes by ``method``."""
    if method == "kernel":
        from .ops import adc

        return adc.adc_scores_kernel(tables, codes, packed=packed)
    if method == "decode":
        return adc_scores_decode(pq, queries, codes, metric=metric)
    return adc_scores(tables, codes, chunk_size=chunk_size)


@functools.partial(
    jax.jit,
    static_argnames=("top_k", "chunk_size", "method", "packed", "metric"),
)
def _search_jit(
    pq: Pq, queries: Array, codes: Array, top_k: int, chunk_size: int,
    method: str, packed: bool = False, metric: str = "l2",
):
    tables = (
        adc_tables(pq, queries, metric=metric) if method != "decode" else None
    )
    scores = _score(pq, queries, tables, codes, chunk_size, method, packed,
                    metric)
    neg_dists, indices = jax.lax.top_k(-scores, top_k)
    return -neg_dists, indices


def _resolve_method(method: str, codes: Array, packed: bool) -> str:
    """``"auto"`` → the ADC kernel where
    :func:`reductive_tpu.dispatch.use_kernel` picks it, else the einsum
    scorer; explicit methods pass through after validation."""
    if method == "auto":
        from .dispatch import use_kernel

        kernel = use_kernel("adc", codes_dtype=codes.dtype, packed=packed)
        method = "kernel" if kernel else "einsum"
    if method not in ("einsum", "kernel", "decode"):
        raise ValueError(f"unknown search method {method!r}")
    return method


@functools.partial(jax.jit, static_argnames=("top_k", "metric"))
def _refine_scores(
    queries: Array, cand: Array, cand_idx: Array, top_k: int,
    metric: str = "l2",
) -> Tuple[Array, Array]:
    """Exact re-scoring core on pre-gathered candidate rows ``(nq, R, d)``;
    padding candidates (``id=-1``) stay at ``+inf``.  ``metric="dot"``
    scores by negated inner product (exact MIPS re-ranking)."""
    if metric == "dot":
        d2 = -jnp.einsum(
            "qrd,qd->qr", cand.astype(jnp.float32),
            queries.astype(jnp.float32), precision="highest",
        )
    else:
        diff = cand.astype(jnp.float32) - queries.astype(jnp.float32)[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)  # (nq, R) exact distances
    d2 = jnp.where(cand_idx >= 0, d2, jnp.inf)
    neg, sel = jax.lax.top_k(-d2, top_k)
    return -neg, jnp.take_along_axis(cand_idx, sel, axis=1)


def _refine_jit(
    queries: Array, corpus, cand_idx: Array, top_k: int,
    metric: str = "l2",
) -> Tuple[Array, Array]:
    """Exact re-scoring of ADC candidates against the original vectors:
    gather the candidate rows, compute true squared distances, and keep
    the best ``top_k``.  O(nq * R * d) — independent of corpus size.

    ``corpus`` is a device/host ``(n, d)`` array, or a **reader**
    (``VecsReader``-like) for corpora larger than HBM — the candidate
    rows (``nq * R``, a few thousand) are fetched from disk and only they
    touch device memory, completing the disk-resident serving loop."""
    from .ivf import _is_reader, _reader_rows
    import numpy as np

    if _is_reader(corpus):
        idx_np = np.asarray(cand_idx)
        safe = np.clip(idx_np, 0, corpus.n - 1).ravel()
        rows = _reader_rows(corpus, safe)
        cand = jnp.asarray(rows.reshape(*idx_np.shape, -1))
    else:
        cand = jnp.take(corpus, cand_idx, axis=0)  # take clips ids
    return _refine_scores(queries, cand, cand_idx, top_k, metric)


def search(
    pq: Pq,
    queries: Array,
    codes: Array,
    top_k: int = 10,
    *,
    chunk_size: int = 16384,
    method: str = "auto",
    stream_chunk: Optional[int] = None,
    packed: bool = False,
    refine_with: Optional[Array] = None,
    refine_factor: int = 4,
    metric: str = "l2",
) -> Tuple[Array, Array]:
    """Top-``top_k`` best encoded vectors per query by ADC.

    Returns ``(distances, indices)`` of shape ``(nq, top_k)`` each, sorted
    ascending by approximate squared distance.  ``metric="dot"`` ranks by
    **descending inner product** instead (MIPS serving; returned scores
    are the negated inner products, still ascending, and exact after
    ``refine_with``).  For cosine similarity, L2-normalize corpus rows
    before encoding and queries before searching — dot == cosine on the
    unit sphere.  :func:`reductive_tpu.ivf.ivf_search` accepts the same
    ``metric`` (IVF-IP, FAISS ``METRIC_INNER_PRODUCT`` analog).

    ``method="auto"`` (default) scores through the GPU lookup-table
    kernel (:func:`reductive_tpu.ops.adc.adc_scores_kernel`) on a GPU
    whenever the codes are u8/packed-u4, and through the einsum scorer
    elsewhere (CPU, wide code dtypes); the choice is
    :func:`reductive_tpu.dispatch.use_kernel`'s.  Both sum the same f32
    table entries, so they agree up to f32 summation order.
    ``method="decode"`` reconstructs and scores with one dense matmul.

    ``packed=True`` searches a **packed-u4** corpus (``(n, m/2)`` bytes,
    :func:`reductive_tpu.ops.pack_u4_codes`; requires ``k <= 16`` and
    ``method="kernel"``) — half the code bytes, twice the corpus per card.

    ``refine_with`` (an ``(n, d)`` device-resident matrix of the original
    vectors, or a ``VecsReader``-like object fetching candidate rows from
    disk for corpora larger than HBM) enables the standard two-stage
    refine: ADC retrieves
    ``top_k * refine_factor`` candidates from the compressed codes, then
    the candidates are re-scored with **exact** distances against the
    originals and the best ``top_k`` returned — quantization error is
    removed from the final ranking (and the returned distances are true
    squared distances) at O(nq * top_k * refine_factor * d) extra cost,
    independent of corpus size.

    ``stream_chunk`` (e.g. ``1 << 20``) switches to the scan-based
    streamed search: the ``(nq, n)`` score matrix never materializes —
    only a running ``(nq, top_k)`` carry — so corpora of hundreds of
    millions of codes search in O(nq * stream_chunk) memory.  When
    ``stream_chunk`` is not given and the score matrix would exceed
    ``_STREAM_SCORE_ELEMS`` f32 elements (256 MB), streaming engages
    automatically — a default-args search over a huge corpus never
    allocates O(nq * n).
    """
    if top_k <= 0:
        raise ValueError("top_k must be >= 1")
    if top_k > codes.shape[0]:
        raise ValueError(
            f"top_k={top_k} exceeds corpus size {codes.shape[0]}"
        )
    method = _resolve_method(method, codes, packed)
    if metric not in ("l2", "dot"):
        raise ValueError(f"unknown metric {metric!r} (expected 'l2' or 'dot')")
    if refine_with is not None:
        if refine_factor < 1:
            raise ValueError("refine_factor must be >= 1")
        n_ref = (
            refine_with.n if not hasattr(refine_with, "shape")
            else refine_with.shape[0]
        )
        if n_ref != codes.shape[0]:
            raise ValueError(
                f"refine_with has {n_ref} rows, codes have "
                f"{codes.shape[0]}"
            )
        r = min(top_k * refine_factor, codes.shape[0])
        _, cand_idx = search(
            pq, queries, codes, r, chunk_size=chunk_size, method=method,
            stream_chunk=stream_chunk, packed=packed, metric=metric,
        )
        return _refine_jit(queries, refine_with, cand_idx, top_k, metric)
    if packed and method != "kernel":
        raise ValueError(
            'packed-u4 codes require method="kernel" (the einsum scorer '
            "consumes unpacked codes — see reductive_tpu.ops.unpack_u4_codes)"
        )

    stream_chunk = _resolve_stream_chunk(
        queries.shape[0], codes.shape[0], stream_chunk, method,
        pq.reconstructed_len,
    )
    if stream_chunk is not None:
        return _search_streamed_jit(
            pq, queries, codes, top_k, stream_chunk, chunk_size, method,
            packed, metric,
        )
    return _search_jit(
        pq, queries, codes, top_k, chunk_size, method, packed, metric
    )


def search_sharded(
    pq: Pq,
    queries: Array,
    codes: Array,
    top_k: int = 10,
    *,
    mesh,
    data_axis: str = "data",
    chunk_size: int = 16384,
    method: str = "auto",
    packed: bool = False,
    metric: str = "l2",
    stream_chunk: Optional[int] = None,
) -> Tuple[Array, Array]:
    """Multi-device exhaustive ADC search: the code matrix sharded over
    ``data_axis``, queries replicated, per-device local top-k merged by
    an all-gather (the same merge as
    :func:`reductive_tpu.ivf.ivf_search_sharded`).

    Results equal single-device :func:`search` on the same corpus — the
    global top-``top_k`` is contained in the union of the per-shard
    top-``top_k``s — while each device scans only its ``n / n_shards``
    codes and the only communication is the final ``(nq, top_k)`` merge.
    A corpus that does not divide evenly over the axis is padded with
    zero codes up to the next multiple; the padded rows are masked out of
    the merge (score ``+inf``, id ``-1``), so results still equal
    single-device :func:`search`.  All :func:`search` scoring options
    (``method``/``packed``/``metric``/``stream_chunk``) apply per shard.
    """
    if top_k <= 0:
        raise ValueError("top_k must be >= 1")
    method = _resolve_method(method, codes, packed)
    if metric not in ("l2", "dot"):
        raise ValueError(f"unknown metric {metric!r} (expected 'l2' or 'dot')")
    n = codes.shape[0]
    n_shards = mesh.shape[data_axis]
    n_true = None
    if n % n_shards != 0:
        pad = n_shards - n % n_shards
        codes = jnp.concatenate(
            [codes, jnp.zeros((pad,) + codes.shape[1:], dtype=codes.dtype)]
        )
        n_true = n
        n = codes.shape[0]
    if top_k > n // n_shards or (n_true is not None and top_k > n_true):
        raise ValueError(
            f"top_k={top_k} exceeds the per-shard corpus {n // n_shards}"
        )
    from jax.sharding import NamedSharding, PartitionSpec as P

    # The same guard search() applies, evaluated at the per-shard scale:
    # auto-streaming once the local (nq, n/n_shards) score matrix would
    # exceed the dense budget.
    stream_chunk = _resolve_stream_chunk(
        queries.shape[0], n // n_shards, stream_chunk, method,
        pq.reconstructed_len,
    )
    codes = jax.device_put(codes, NamedSharding(mesh, P(data_axis, None)))
    run = _search_sharded_fn(
        mesh, data_axis, top_k, chunk_size, method, packed, metric,
        stream_chunk, n_true,
    )
    return run(pq, queries, codes)


@functools.lru_cache(maxsize=None)
def _search_sharded_fn(mesh, data_axis: str, top_k: int, chunk_size: int,
                       method: str, packed: bool, metric: str,
                       stream_chunk, n_true=None):
    """Build (and cache) the jitted sharded exhaustive search for a
    mesh/config — a fresh closure per call would re-trace every time."""
    from jax.sharding import PartitionSpec as P

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(data_axis, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(pq, q, codes_local):
        n_local = codes_local.shape[0]
        if stream_chunk is not None:
            d_loc, i_loc = _search_streamed_jit(
                pq, q, codes_local, top_k, stream_chunk, chunk_size,
                method, packed, metric,
            )
        else:
            d_loc, i_loc = _search_jit(
                pq, q, codes_local, top_k, chunk_size, method, packed, metric,
            )
        # Local row offsets -> global corpus rows.
        shard = jax.lax.axis_index(data_axis)
        i_loc = i_loc + shard * n_local
        if n_true is not None:
            # Rows past the true corpus are zero-padding added for even
            # sharding: drop them from the merge (+inf never wins for
            # either metric — dot scores are negated, ascending = best).
            pad_row = i_loc >= n_true
            d_loc = jnp.where(pad_row, jnp.inf, d_loc)
            i_loc = jnp.where(pad_row, -1, i_loc)
        d_all = jax.lax.all_gather(d_loc, data_axis)  # (ndev, nq, top_k)
        i_all = jax.lax.all_gather(i_loc, data_axis)
        nq = q.shape[0]
        d_flat = jnp.moveaxis(d_all, 0, 1).reshape(nq, -1)
        i_flat = jnp.moveaxis(i_all, 0, 1).reshape(nq, -1)
        neg, sel = jax.lax.top_k(-d_flat, top_k)
        return -neg, jnp.take_along_axis(i_flat, sel, axis=1)

    return run

"""IVF-PQ tests: build invariants, exhaustive-probe equivalence, recall."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from reductive_tpu import train_pq
from reductive_tpu.ivf import (
    IvfPq, build_ivf, ivf_search, ivf_search_sharded, train_ivf_pq,
)


def clustered_data(key, n_clusters=16, per=200, d=16, spread=0.15):
    kc, kn = jax.random.split(key)
    centers = jax.random.normal(kc, (n_clusters, d)) * 3.0
    noise = jax.random.normal(kn, (n_clusters, per, d)) * spread
    return (centers[:, None, :] + noise).reshape(-1, d).astype(jnp.float32)


def test_build_invariants():
    """Every corpus row lands in exactly one cell slot; stored codes are
    the residual encodings of their rows."""
    key = jax.random.PRNGKey(0)
    x = clustered_data(key)
    n = x.shape[0]
    coarse, pq = train_ivf_pq(key, x, 8, 4, 4, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, use_kernel=False)

    ids = np.asarray(index.cell_ids)
    valid = ids >= 0
    flat = ids[valid]
    assert len(flat) == n
    assert len(set(flat.tolist())) == n  # every row exactly once

    # Spot-check stored codes vs recomputed residual encodings.
    from reductive_tpu.kmeans import cluster_assignments

    rows = np.asarray(flat[:50])
    assign = cluster_assignments(coarse, x[rows])
    res = x[rows] - jnp.take(coarse, assign, axis=0)
    expect = np.asarray(pq.quantize_batch(res))
    got = np.asarray(index.cell_codes)[valid][:50]
    np.testing.assert_array_equal(got, expect)


def test_full_probe_matches_bruteforce():
    """With nprobe = n_cells, IVF search ranks exactly like brute force
    over the residual reconstructions (the same approximation)."""
    key = jax.random.PRNGKey(1)
    x = clustered_data(key, n_clusters=8, per=100)
    C = 8
    coarse, pq = train_ivf_pq(key, x, C, 4, 4, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, use_kernel=False)

    kq = jax.random.PRNGKey(2)
    queries = x[::97][:9] + 0.05 * jax.random.normal(kq, (9, x.shape[1]))

    d_ivf, i_ivf = ivf_search(index, queries, top_k=5, nprobe=C)

    # Brute-force oracle: approx distance to centroid + residual recon.
    from reductive_tpu.kmeans import cluster_assignments

    assign = cluster_assignments(coarse, x)
    res = x - jnp.take(coarse, assign, axis=0)
    codes = pq.quantize_batch(res)
    rec = jnp.take(coarse, assign, axis=0) + pq.reconstruct_batch(codes)
    d2 = jnp.sum((queries[:, None, :] - rec[None, :, :]) ** 2, axis=-1)
    neg, idx = jax.lax.top_k(-d2, 5)
    np.testing.assert_array_equal(np.asarray(i_ivf), np.asarray(idx))
    np.testing.assert_allclose(
        np.asarray(d_ivf), np.asarray(-neg), rtol=1e-3, atol=1e-3
    )


def test_recall_with_few_probes():
    """On clustered data, a few probes recover the planted neighbors."""
    key = jax.random.PRNGKey(3)
    x = clustered_data(key, n_clusters=32, per=100, d=16)
    coarse, pq = train_ivf_pq(key, x, 32, 4, 4, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, use_kernel=False)

    kq = jax.random.PRNGKey(4)
    planted = np.arange(0, 3200, 100)
    queries = x[planted] + 0.02 * jax.random.normal(kq, (32, 16))
    _, idx = ivf_search(index, queries, top_k=10, nprobe=4)
    recall = float(np.mean([
        planted[q] in np.asarray(idx[q]) for q in range(len(planted))
    ]))
    assert recall > 0.9, recall


def test_underfull_cells_pad_with_minus_one():
    """top_k beyond the probed candidates pads with id=-1 / dist=+inf."""
    key = jax.random.PRNGKey(5)
    x = jax.random.normal(key, (20, 8), dtype=jnp.float32)
    pq = train_pq(key, x, 2, 2, 4)
    codes_dummy = pq.quantize_batch(x)
    coarse = x[:4]  # 4 cells, ~5 rows each
    index = build_ivf(coarse, pq, x, use_kernel=False)
    d, i = ivf_search(index, x[:2], top_k=15, nprobe=1)
    i = np.asarray(i)
    d = np.asarray(d)
    assert (i == -1).any()
    assert np.isinf(d[i == -1]).all()
    # Valid entries sort ascending before the padding.
    for row_d, row_i in zip(d, i):
        nv = (row_i >= 0).sum()
        assert (np.diff(row_d[:nv]) >= -1e-6).all()


def test_capacity_cap_overflow_modes(caplog):
    """A bounded build can never lose rows silently: "drop" warns AND
    exposes the ids programmatically, "error" raises, "spill" with
    insufficient total capacity raises instead of dropping."""
    import logging

    key = jax.random.PRNGKey(6)
    x = clustered_data(key, n_clusters=4, per=50, d=8)
    n = x.shape[0]
    coarse, pq = train_ivf_pq(key, x, 4, 2, 3, use_kernel=False,
                              train_sample=None)
    # C*L = 40 < n = 200: only "drop" can produce an index at all.
    with caplog.at_level(logging.WARNING, logger="reductive_tpu"):
        index = build_ivf(coarse, pq, x, capacity=10, use_kernel=False,
                          on_overflow="drop")
    assert index.capacity == 10
    assert any("dropped" in r.message for r in caplog.records)
    ids = np.asarray(index.cell_ids)
    placed = ids[ids >= 0]
    assert index.dropped_ids.size == n - len(placed) > 0
    # dropped + placed partition the corpus exactly.
    assert (
        sorted(placed.tolist() + index.dropped_ids.tolist())
        == list(range(n))
    )

    with pytest.raises(ValueError, match="candidate cells"):
        build_ivf(coarse, pq, x, capacity=10, use_kernel=False,
                  on_overflow="error")
    with pytest.raises(ValueError, match="no spill placement"):
        build_ivf(coarse, pq, x, capacity=10, use_kernel=False,
                  on_overflow="spill")
    with pytest.raises(ValueError, match="on_overflow"):
        build_ivf(coarse, pq, x, capacity=10, use_kernel=False,
                  on_overflow="panic")


def test_spill_places_every_row():
    """With total capacity >= n, the default on_overflow="spill" stores
    every corpus row exactly once even when the per-candidate greedy pass
    overflows, and the stored codes match the storage cell's centroid."""
    key = jax.random.PRNGKey(60)
    x = clustered_data(key, n_clusters=4, per=50, d=8, spread=0.3)
    n = x.shape[0]
    coarse, pq = train_ivf_pq(key, x, 4, 2, 3, use_kernel=False,
                              train_sample=None)
    # Exact-fit total capacity with few overflow candidates: the bounded
    # pass is guaranteed to leave leftovers on clustered data, the spill
    # pass must place them all.
    index = build_ivf(coarse, pq, x, capacity=50, overflow_candidates=2,
                      use_kernel=False)
    assert index.dropped_ids.size == 0
    ids = np.asarray(index.cell_ids)
    flat = ids[ids >= 0]
    assert len(flat) == n and len(set(flat.tolist())) == n

    cells, slots = np.nonzero(ids >= 0)
    rows = ids[cells, slots]
    res = x[rows] - jnp.take(coarse, cells, axis=0)
    expect = np.asarray(pq.quantize_batch(res))
    np.testing.assert_array_equal(
        np.asarray(index.cell_codes)[cells, slots], expect
    )


def test_ivf_index_is_a_pytree():
    key = jax.random.PRNGKey(7)
    x = clustered_data(key, n_clusters=4, per=40, d=8)
    coarse, pq = train_ivf_pq(key, x, 4, 2, 3, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, use_kernel=False)
    leaves = jax.tree_util.tree_leaves(index)
    assert len(leaves) >= 4
    rebuilt = jax.tree_util.tree_map(lambda a: a, index)
    np.testing.assert_array_equal(
        np.asarray(rebuilt.cell_ids), np.asarray(index.cell_ids)
    )


def test_ivf_artifact_roundtrip(tmp_path):
    """IvfPq persists through the io artifact and searches identically."""
    from reductive_tpu import io as rio

    key = jax.random.PRNGKey(8)
    x = clustered_data(key, n_clusters=4, per=60, d=8)
    coarse, pq = train_ivf_pq(key, x, 4, 2, 3, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, use_kernel=False)
    path = str(tmp_path / "ivf.npz")
    rio.save(path, index)
    loaded = rio.load(path)
    assert isinstance(loaded, IvfPq)
    q = x[:3]
    d0, i0 = ivf_search(index, q, top_k=5, nprobe=2, use_kernel=False)
    d1, i1 = ivf_search(loaded, q, top_k=5, nprobe=2, use_kernel=False)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), rtol=1e-6)


def test_auto_capacity_overflow_placement():
    """capacity="auto" bounds L near the mean cell size; overflow rows
    land in secondary candidate cells (encoded against that centroid) and
    every row is still stored exactly once."""
    key = jax.random.PRNGKey(9)
    x = clustered_data(key, n_clusters=8, per=150, d=8, spread=0.4)
    n = x.shape[0]
    coarse, pq = train_ivf_pq(key, x, 8, 2, 3, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, capacity="auto", use_kernel=False)
    assert index.capacity == int(np.ceil(1.25 * n / 8))

    ids = np.asarray(index.cell_ids)
    flat = ids[ids >= 0]
    assert len(flat) == n and len(set(flat.tolist())) == n

    # Stored codes are consistent with the *storage* cell's centroid.
    C, L = ids.shape
    cells, slots = np.nonzero(ids >= 0)
    rows = ids[cells, slots]
    res = x[rows] - jnp.take(coarse, cells, axis=0)
    expect = np.asarray(pq.quantize_batch(res))
    np.testing.assert_array_equal(np.asarray(index.cell_codes)[cells, slots], expect)

    # Search still finds planted neighbors.
    kq = jax.random.PRNGKey(10)
    planted = np.arange(0, n, 150)
    queries = x[planted] + 0.02 * jax.random.normal(kq, (len(planted), 8))
    _, idx = ivf_search(index, queries, top_k=10, nprobe=3, use_kernel=False)
    recall = float(np.mean([
        planted[q] in np.asarray(idx[q]) for q in range(len(planted))
    ]))
    assert recall > 0.8, recall


def test_ivf_search_sharded_matches_single_device():
    """Cells sharded over the virtual mesh: the merged result is at least
    as good as the single-device search (superset of probed cells), and
    exactly equal when nprobe covers everything."""
    from reductive_tpu.parallel import make_mesh
    from reductive_tpu.ivf import ivf_search_sharded

    key = jax.random.PRNGKey(11)
    x = clustered_data(key, n_clusters=16, per=60, d=8)
    coarse, pq = train_ivf_pq(key, x, 16, 2, 3, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, capacity="auto", use_kernel=False)
    mesh = make_mesh()  # 8 virtual CPU devices -> 2 cells per shard
    queries = x[:6]

    # Full coverage: nprobe = cells per shard probes every cell globally.
    d_sh, i_sh = ivf_search_sharded(
        index, queries, top_k=5, nprobe=2, mesh=mesh, use_kernel=False,
    )
    d_1d, i_1d = ivf_search(index, queries, top_k=5, nprobe=16,
                            use_kernel=False)
    np.testing.assert_array_equal(np.asarray(i_sh), np.asarray(i_1d))
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d_1d),
                               rtol=1e-5, atol=1e-5)

    # Partial probing: sharded candidates are a superset of the
    # single-device probes at the same nprobe, so its top-1 distance is
    # never worse.
    d_sh1, _ = ivf_search_sharded(
        index, queries, top_k=1, nprobe=1, mesh=mesh, use_kernel=False,
    )
    d_1d1, _ = ivf_search(index, queries, top_k=1, nprobe=1,
                          use_kernel=False)
    assert np.all(np.asarray(d_sh1) <= np.asarray(d_1d1) + 1e-5)

    import pytest

    with pytest.raises(ValueError, match="per-shard"):
        ivf_search_sharded(index, queries, top_k=1, nprobe=3, mesh=mesh)


def test_ivf_search_sharded_pads_non_divisible_cells():
    """A cell count that does not divide the mesh axis is padded with
    empty cells, which are excluded from probe selection — full-coverage
    results equal the single-device search exactly (VERDICT r3 weak #6)."""
    from reductive_tpu.parallel import make_mesh
    from reductive_tpu.ivf import ivf_search_sharded

    key = jax.random.PRNGKey(13)
    x = clustered_data(key, n_clusters=13, per=60, d=8)
    coarse, pq = train_ivf_pq(key, x, 13, 2, 3, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, capacity="auto", use_kernel=False)
    assert index.n_cells == 13  # prime: pads to 16 over 8 shards
    mesh = make_mesh()  # 8 virtual CPU devices
    queries = x[:6]

    # nprobe=2 over 8 shards covers all 13 real cells (2*8 >= 13 and the
    # 3 pads are never probed), so the merged result must equal the
    # single-device full scan.
    d_sh, i_sh = ivf_search_sharded(
        index, queries, top_k=5, nprobe=2, mesh=mesh, use_kernel=False,
    )
    d_1d, i_1d = ivf_search(index, queries, top_k=5, nprobe=13,
                            use_kernel=False)
    np.testing.assert_array_equal(np.asarray(i_sh), np.asarray(i_1d))
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d_1d),
                               rtol=1e-5, atol=1e-5)
    assert np.all(np.asarray(i_sh) >= 0)


def test_ivf_opq_residuals_and_refine():
    """residual_quantizer="gaussian_opq" carries a projection through
    build and search; refine_with re-scores IVF candidates exactly."""
    key = jax.random.PRNGKey(12)
    x = clustered_data(key, n_clusters=8, per=100, d=16)
    n = x.shape[0]
    coarse, rpq = train_ivf_pq(
        key, x, 8, 4, 3, use_kernel=False, train_sample=None,
        residual_quantizer="gaussian_opq",
    )
    assert rpq.projection is not None
    index = build_ivf(coarse, rpq, x, capacity="auto", use_kernel=False)

    kq = jax.random.PRNGKey(13)
    planted = np.arange(0, n, 100)
    queries = x[planted] + 0.02 * jax.random.normal(kq, (len(planted), 16))

    # Projection path: full probe matches brute force over the same
    # approximation (centroid + R^T recon).
    d_ivf, i_ivf = ivf_search(index, queries, top_k=5, nprobe=8,
                              use_kernel=False)
    ids = np.asarray(index.cell_ids)
    cells, slots = np.nonzero(ids >= 0)
    rows = ids[cells, slots]
    rec = np.asarray(rpq.reconstruct_batch(
        jnp.asarray(np.asarray(index.cell_codes)[cells, slots])
    ))
    approx = np.zeros_like(np.asarray(x))
    approx[rows] = np.asarray(coarse)[cells] + rec
    d2 = np.sum(
        (np.asarray(queries)[:, None, :] - approx[None, :, :]) ** 2, axis=-1
    )
    expect_idx = np.argsort(d2, axis=1)[:, :5]
    np.testing.assert_array_equal(np.asarray(i_ivf), expect_idx)

    # Exact refine returns true distances and at-least-as-good recall.
    d_ref, i_ref = ivf_search(index, queries, top_k=5, nprobe=8,
                              use_kernel=False, refine_with=x,
                              refine_factor=8)
    full = np.sum(
        (np.asarray(queries)[:, None, :] - np.asarray(x)[None, :, :]) ** 2,
        axis=-1,
    )
    np.testing.assert_allclose(
        np.asarray(d_ref)[:, 0],
        full[np.arange(len(planted)), np.asarray(i_ref)[:, 0]],
        rtol=1e-4, atol=1e-4,
    )
    with pytest.raises(ValueError, match="residual_quantizer"):
        train_ivf_pq(key, x, 8, 4, 3, use_kernel=False,
                     residual_quantizer="opq2")


def test_build_from_reader_matches_in_memory(tmp_path):
    """build_ivf from an on-disk reader (>HBM path) produces the exact
    same index as the in-memory build on the same corpus."""
    from reductive_tpu.native import VecsReader, write_fvecs

    key = jax.random.PRNGKey(70)
    x = clustered_data(key, n_clusters=8, per=120, d=16, spread=0.3)
    path = str(tmp_path / "corpus.fvecs")
    write_fvecs(path, np.asarray(x))

    coarse, pq = train_ivf_pq(key, x, 8, 4, 4, use_kernel=False,
                              train_sample=None)
    mem = build_ivf(coarse, pq, x, capacity="auto", use_kernel=False,
                    batch=256)
    with VecsReader(path) as reader:
        disk = build_ivf(coarse, pq, reader, capacity="auto",
                         use_kernel=False, batch=256)
    np.testing.assert_array_equal(
        np.asarray(disk.cell_ids), np.asarray(mem.cell_ids)
    )
    np.testing.assert_array_equal(
        np.asarray(disk.cell_codes), np.asarray(mem.cell_codes)
    )
    np.testing.assert_allclose(
        np.asarray(disk.cell_norms), np.asarray(mem.cell_norms),
        rtol=1e-6, atol=1e-6,
    )


def test_build_from_reader_drop_mode(tmp_path):
    """Reader-path pass 2 handles holes (dropped rows) via host filter +
    zero padding; stored rows partition exactly as in the array path."""
    from reductive_tpu.native import VecsReader, write_fvecs

    key = jax.random.PRNGKey(71)
    x = clustered_data(key, n_clusters=4, per=50, d=8)
    n = x.shape[0]
    path = str(tmp_path / "corpus.fvecs")
    write_fvecs(path, np.asarray(x))
    coarse, pq = train_ivf_pq(key, x, 4, 2, 3, use_kernel=False,
                              train_sample=None)
    mem = build_ivf(coarse, pq, x, capacity=10, use_kernel=False,
                    on_overflow="drop", batch=64)
    with VecsReader(path) as reader:
        disk = build_ivf(coarse, pq, reader, capacity=10, use_kernel=False,
                         on_overflow="drop", batch=64)
    np.testing.assert_array_equal(
        np.asarray(disk.cell_ids), np.asarray(mem.cell_ids)
    )
    np.testing.assert_array_equal(disk.dropped_ids, mem.dropped_ids)
    assert disk.dropped_ids.size > 0


def test_train_ivf_pq_from_reader(tmp_path):
    """train_ivf_pq accepts a reader: sampled training from disk, then a
    streamed build + search end-to-end without the corpus in memory."""
    from reductive_tpu.native import VecsReader, write_fvecs

    key = jax.random.PRNGKey(72)
    x = clustered_data(key, n_clusters=16, per=100, d=16)
    n = x.shape[0]
    path = str(tmp_path / "corpus.fvecs")
    write_fvecs(path, np.asarray(x))
    with VecsReader(path) as reader:
        coarse, pq = train_ivf_pq(key, reader, 16, 4, 4, use_kernel=False,
                                  train_sample=512)
        index = build_ivf(coarse, pq, reader, capacity="auto",
                          use_kernel=False)
    assert index.dropped_ids.size == 0
    ids = np.asarray(index.cell_ids)
    flat = ids[ids >= 0]
    assert len(flat) == n and len(set(flat.tolist())) == n
    kq = jax.random.PRNGKey(73)
    planted = np.arange(0, n, 100)
    queries = x[planted] + 0.02 * jax.random.normal(kq, (len(planted), 16))
    _, idx = ivf_search(index, queries, top_k=10, nprobe=4, use_kernel=False)
    recall = float(np.mean([
        planted[q] in np.asarray(idx[q]) for q in range(len(planted))
    ]))
    assert recall > 0.85, recall


def test_full_probe_dot_metric_matches_bruteforce_mips():
    """With nprobe = n_cells, metric='dot' ranks exactly like brute-force
    inner product against the residual reconstructions."""
    key = jax.random.PRNGKey(21)
    x = clustered_data(key, n_clusters=8, per=100)
    C = 8
    coarse, pq = train_ivf_pq(key, x, C, 4, 4, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, use_kernel=False)

    kq = jax.random.PRNGKey(22)
    queries = jax.random.normal(kq, (9, x.shape[1]))

    d_ivf, i_ivf = ivf_search(index, queries, top_k=5, nprobe=C,
                              metric="dot")

    from reductive_tpu.kmeans import cluster_assignments

    assign = cluster_assignments(coarse, x)
    res = x - jnp.take(coarse, assign, axis=0)
    codes = pq.quantize_batch(res)
    rec = jnp.take(coarse, assign, axis=0) + pq.reconstruct_batch(codes)
    ip = jnp.einsum("qd,nd->qn", queries, rec, precision="highest")
    neg_ip, idx = jax.lax.top_k(ip, 5)
    np.testing.assert_array_equal(np.asarray(i_ivf), np.asarray(idx))
    np.testing.assert_allclose(
        np.asarray(d_ivf), np.asarray(-neg_ip), rtol=1e-3, atol=1e-3
    )


def test_ivf_dot_metric_recall_and_refine():
    """On normalized clustered data (cosine regime), few-probe IVF-IP
    recovers the planted neighbors; refine returns exact negated IPs."""
    key = jax.random.PRNGKey(23)
    x = clustered_data(key, n_clusters=32, per=100, d=16)
    x = x / jnp.linalg.norm(x, axis=1, keepdims=True)
    coarse, pq = train_ivf_pq(key, x, 32, 4, 4, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, use_kernel=False)

    kq = jax.random.PRNGKey(24)
    planted = np.arange(0, 3200, 100)
    queries = x[planted] + 0.02 * jax.random.normal(kq, (32, 16))
    queries = queries / jnp.linalg.norm(queries, axis=1, keepdims=True)
    # On the unit sphere cluster-mates are nearly identical, so raw
    # m=4/k=16 ADC barely separates them — the production recipe is
    # IVF-IP shortlist + exact refine (probe selection itself is
    # verified exact in test_full_probe_dot_metric_matches_bruteforce_mips).
    # Judge against the exact MIPS oracle, not the planted id (the
    # planted row is not in the true IP top-5 for ~20% of queries here).
    d_r, i_r = ivf_search(index, queries, top_k=5, nprobe=4, metric="dot",
                          refine_with=x, refine_factor=16)
    true_ip_all = jnp.einsum("qd,nd->qn", queries, x, precision="highest")
    oracle5 = np.asarray(jax.lax.top_k(true_ip_all, 5)[1])
    overlap = float(np.mean([
        len(set(np.asarray(i_r[q]).tolist()) & set(oracle5[q].tolist())) / 5
        for q in range(len(planted))
    ]))
    assert overlap >= 0.85, overlap
    true_ip = jnp.einsum("qd,nd->qn", queries, x, precision="highest")
    got = np.take_along_axis(np.asarray(true_ip), np.asarray(i_r), axis=1)
    np.testing.assert_allclose(np.asarray(d_r), -got, rtol=1e-5, atol=1e-5)


def test_ivf_sharded_dot_metric_superset_property():
    """Sharded IVF-IP: per-shard top-nprobe cells are a superset of the
    global top-nprobe, so sharded best scores are <= single-device ones
    (same guaranteed property the L2 dryrun asserts)."""
    if len(jax.devices()) < 4:
        import pytest as _pytest
        _pytest.skip("needs the 8-device CPU mesh")
    from reductive_tpu.parallel import make_mesh
    from reductive_tpu.ivf import ivf_search_sharded

    key = jax.random.PRNGKey(25)
    x = clustered_data(key, n_clusters=16, per=64, d=16)
    coarse, pq = train_ivf_pq(key, x, 16, 4, 4, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, use_kernel=False)
    queries = jax.random.normal(jax.random.PRNGKey(26), (6, 16))

    mesh = make_mesh((4,), ("data",), devices=jax.devices()[:4])
    d_sh, i_sh = ivf_search_sharded(index, queries, top_k=5, nprobe=2,
                                    mesh=mesh, use_kernel=False,
                                    metric="dot")
    d_1, _ = ivf_search(index, queries, top_k=5, nprobe=2,
                        use_kernel=False, metric="dot")
    assert np.all(np.asarray(d_sh) <= np.asarray(d_1) + 1e-5)
    assert np.all(np.asarray(i_sh) >= 0)


def test_ivf_metric_validation():
    key = jax.random.PRNGKey(27)
    x = clustered_data(key, n_clusters=4, per=50)
    coarse, pq = train_ivf_pq(key, x, 4, 4, 4, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, use_kernel=False)
    q = x[:2]
    with pytest.raises(ValueError, match="unknown metric"):
        ivf_search(index, q, top_k=3, metric="cosine")


def test_ivf_add_then_search_finds_new_rows():
    key = jax.random.PRNGKey(41)
    x = clustered_data(key, n_clusters=8, per=80)
    coarse, pq = train_ivf_pq(key, x, 8, 4, 4, use_kernel=False,
                              train_sample=None)
    # Leave headroom for adds.
    index = build_ivf(coarse, pq, x, capacity=120, use_kernel=False)
    from reductive_tpu.ivf import ivf_add

    x_new = clustered_data(jax.random.PRNGKey(42), n_clusters=8, per=10)
    idx2 = ivf_add(index, x_new, use_kernel=False)
    assert idx2.dropped_ids.size == 0
    # Old index untouched (functional update).
    assert int((np.asarray(index.cell_ids) >= 0).sum()) == x.shape[0]
    assert int((np.asarray(idx2.cell_ids) >= 0).sum()) == (
        x.shape[0] + x_new.shape[0]
    )
    # New rows got ids n..n+79 and are retrievable.
    # One query per added cluster (cluster-mates share a PQ code, so
    # within-cluster ranking is pure tie-break); the check is that SOME
    # row of the queried new cluster comes back first.
    q = x_new[::10][:8]
    _, ids = ivf_search(idx2, q, top_k=3, nprobe=8, use_kernel=False)
    first = np.asarray(ids)[:, 0]
    cluster_of = (first - x.shape[0]) // 10
    assert (first >= x.shape[0]).all(), first
    np.testing.assert_array_equal(cluster_of, np.arange(8))
    # Added rows score identically to a fresh build of the union corpus.
    both = jnp.concatenate([x, x_new])
    rebuilt = build_ivf(coarse, pq, both, capacity=120, use_kernel=False)
    d_a, i_a = ivf_search(idx2, q, top_k=5, nprobe=8, use_kernel=False)
    d_r, i_r = ivf_search(rebuilt, q, top_k=5, nprobe=8, use_kernel=False)
    np.testing.assert_allclose(np.asarray(d_a), np.asarray(d_r),
                               rtol=1e-5, atol=1e-5)


def test_ivf_remove_masks_and_slots_are_reused():
    key = jax.random.PRNGKey(43)
    x = clustered_data(key, n_clusters=4, per=60)
    coarse, pq = train_ivf_pq(key, x, 4, 4, 4, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, use_kernel=False)
    from reductive_tpu.ivf import ivf_add, ivf_remove

    gone = np.arange(0, 240, 3)  # remove a third
    idx2 = ivf_remove(index, gone)
    assert int((np.asarray(idx2.cell_ids) >= 0).sum()) == 240 - len(gone)
    # Removed ids never come back from search.
    _, ids = ivf_search(idx2, x[:8], top_k=5, nprobe=4, use_kernel=False)
    assert not np.isin(np.asarray(ids)[np.asarray(ids) >= 0], gone).any()
    # Removal is idempotent.
    idx3 = ivf_remove(idx2, gone)
    np.testing.assert_array_equal(
        np.asarray(idx2.cell_ids), np.asarray(idx3.cell_ids)
    )
    # Freed (mid-cell) slots are reused by a subsequent add, with the
    # remap handling non-prefix occupancy.
    cap_before = idx2.capacity
    x_new = clustered_data(jax.random.PRNGKey(44), n_clusters=4, per=15)
    idx4 = ivf_add(idx2, x_new, use_kernel=False)
    assert idx4.capacity == cap_before  # no growth: holes were reused
    assert int((np.asarray(idx4.cell_ids) >= 0).sum()) == (
        240 - len(gone) + 60
    )
    # Every live (cell, slot) pair is unique and in range.
    live = np.argwhere(np.asarray(idx4.cell_ids) >= 0)
    assert len(live) == len({(c, s) for c, s in live})
    # The re-added rows are searchable.
    _, ids = ivf_search(idx4, x_new[:8], top_k=3, nprobe=4,
                        use_kernel=False)
    new_id0 = int(np.asarray(idx2.cell_ids).max()) + 1
    assert (np.asarray(ids)[:, 0] >= new_id0).mean() >= 0.8


def test_ivf_add_validation():
    key = jax.random.PRNGKey(45)
    x = clustered_data(key, n_clusters=4, per=30)
    coarse, pq = train_ivf_pq(key, x, 4, 4, 4, use_kernel=False,
                              train_sample=None)
    from reductive_tpu.ivf import ivf_add

    index = build_ivf(coarse, pq, x, use_kernel=False)  # capacity = max cell
    x_new = clustered_data(jax.random.PRNGKey(46), n_clusters=4, per=30)
    # id clash
    with pytest.raises(ValueError, match="already live"):
        ivf_add(index, x_new[:5], ids=np.arange(5), use_kernel=False)
    with pytest.raises(ValueError, match="duplicate ids"):
        ivf_add(index, x_new[:3], ids=np.array([500, 500, 501]),
                use_kernel=False)
    # Exceeding total capacity fails loudly under spill/error.
    free = index.n_cells * index.capacity - x.shape[0]
    if free < x_new.shape[0]:
        with pytest.raises(ValueError, match="total free capacity"):
            ivf_add(index, x_new, use_kernel=False)
    # cell_ids is int32: ids >= 2^31 must be rejected, not wrapped (a
    # wrapped id would be stored negative = "empty" or alias a live row).
    with pytest.raises(ValueError, match="int32"):
        ivf_add(index, x_new[:2], ids=np.array([7, 2 ** 32]),
                use_kernel=False)


def test_ivf_remove_ignores_out_of_range_ids():
    # ivf_remove(index, [2**32]) must NOT wrap to 0 and delete row 0 —
    # ids outside int32 cannot be present and are ignored (idempotent
    # remove semantics).
    key = jax.random.PRNGKey(48)
    x = clustered_data(key, n_clusters=4, per=30)
    coarse, pq = train_ivf_pq(key, x, 4, 4, 4, use_kernel=False,
                              train_sample=None)
    from reductive_tpu.ivf import ivf_remove

    index = build_ivf(coarse, pq, x, use_kernel=False)
    before = np.sort(np.asarray(index.cell_ids).ravel())
    idx2 = ivf_remove(index, np.array([2 ** 32, 2 ** 31, -5], dtype=np.int64))
    after = np.sort(np.asarray(idx2.cell_ids).ravel())
    np.testing.assert_array_equal(before, after)


def test_ivf_add_with_opq_residuals():
    # ivf_add must honor the residual quantizer's rotation (codes are
    # produced in projected space, exactly like the build).
    key = jax.random.PRNGKey(47)
    x = clustered_data(key, n_clusters=4, per=50)
    coarse, pq = train_ivf_pq(key, x, 4, 4, 4, use_kernel=False,
                              train_sample=None,
                              residual_quantizer="gaussian_opq")
    assert pq.projection is not None
    from reductive_tpu.ivf import ivf_add

    index = build_ivf(coarse, pq, x, capacity=80, use_kernel=False)
    x_new = clustered_data(jax.random.PRNGKey(48), n_clusters=4, per=5)
    idx2 = ivf_add(index, x_new, use_kernel=False)
    # Stored codes equal a fresh rotated residual encode of each new row
    # against its storage centroid.
    ci = np.asarray(idx2.cell_ids)
    n0 = x.shape[0]
    for i in range(x_new.shape[0]):
        c, s = np.argwhere(ci == n0 + i)[0]
        res = (x_new[i] - np.asarray(coarse)[c])[None]
        expect = np.asarray(pq.quantize_batch(jnp.asarray(res)))[0]
        np.testing.assert_array_equal(
            np.asarray(idx2.cell_codes)[c, s], expect
        )


def test_ivf_add_preserves_dropped_ids_record():
    # A build under on_overflow="drop" records its dropped rows; a later
    # add must accumulate with (not overwrite) that record.
    key = jax.random.PRNGKey(49)
    x = clustered_data(key, n_clusters=4, per=50, d=8)
    coarse, pq = train_ivf_pq(key, x, 4, 2, 3, use_kernel=False,
                              train_sample=None)
    from reductive_tpu.ivf import ivf_add, ivf_remove

    index = build_ivf(coarse, pq, x, capacity=30, use_kernel=False,
                      on_overflow="drop")
    assert index.dropped_ids.size > 0
    before = set(index.dropped_ids.tolist())
    # Free some room first so the add itself drops nothing.
    idx2 = ivf_remove(index, np.asarray(list(
        set(np.asarray(index.cell_ids)[np.asarray(index.cell_ids) >= 0]
            .ravel().tolist()))[:20]))
    idx3 = ivf_add(idx2, x[:5] + 3.0, use_kernel=False)
    assert before <= set(idx3.dropped_ids.tolist())


def test_spherical_coarse_training():
    # Spherical k-means coarse stage: unit-norm centroids, sensible
    # IVF-IP behavior on a normalized corpus.
    key = jax.random.PRNGKey(51)
    x = clustered_data(key, n_clusters=16, per=60, d=16)
    x = x / jnp.linalg.norm(x, axis=1, keepdims=True)
    coarse, pq = train_ivf_pq(key, x, 16, 4, 4, use_kernel=False,
                              train_sample=None,
                              coarse_metric="spherical")
    norms = np.asarray(jnp.linalg.norm(coarse, axis=1))
    live = norms > 0  # empty clusters stay zero
    assert live.sum() >= 12
    np.testing.assert_allclose(norms[live], 1.0, rtol=1e-5)

    index = build_ivf(coarse, pq, x, use_kernel=False)
    planted = np.arange(0, x.shape[0], 60)
    q = x[planted]
    # Generous refine pool: merged cells hold ~120 near-identical rows
    # whose approximate IPs tie, so the shortlist must be deep enough for
    # the exact re-scoring to surface the row itself.
    _, ids = ivf_search(index, q, top_k=5, nprobe=8, metric="dot",
                        refine_with=x, refine_factor=24)
    # The query IS a corpus row: exact refine must put it first.
    assert (np.asarray(ids)[:, 0] == planted).mean() >= 0.9

    with pytest.raises(ValueError, match="coarse_metric"):
        train_ivf_pq(key, x, 8, 4, 4, use_kernel=False,
                     train_sample=None, coarse_metric="cosine")


def test_packed_cells_bit_equal():
    """packed=True (k<=16): half-size cell tensor, search results
    bit-equal to the unpacked index; add/remove handle packed cells;
    io round-trips the packed layout."""
    key = jax.random.PRNGKey(52)
    x = clustered_data(key, n_clusters=8, per=100, d=16)
    coarse, pq = train_ivf_pq(key, x, 8, 4, 4, use_kernel=False,
                              train_sample=None)
    idx_u = build_ivf(coarse, pq, x, use_kernel=False)
    idx_p = build_ivf(coarse, pq, x, use_kernel=False, packed=True)
    assert not idx_u.packed and idx_p.packed
    assert idx_p.cell_codes.shape[2] == idx_u.cell_codes.shape[2] // 2

    q = x[::77][:8]
    for metric in ("l2", "dot"):
        d_u, i_u = ivf_search(idx_u, q, top_k=5, nprobe=4, metric=metric)
        d_p, i_p = ivf_search(idx_p, q, top_k=5, nprobe=4, metric=metric)
        np.testing.assert_array_equal(np.asarray(i_u), np.asarray(i_p))
        np.testing.assert_array_equal(np.asarray(d_u), np.asarray(d_p))

    # Adds pack the new codes into the same layout (results stay equal
    # to the unpacked index receiving the same rows).
    from reductive_tpu.ivf import ivf_add, ivf_remove

    gone = np.arange(0, x.shape[0], 17)
    x_new = clustered_data(jax.random.PRNGKey(53), n_clusters=8, per=4,
                           d=16)
    idx_u2 = ivf_add(ivf_remove(idx_u, gone), x_new, use_kernel=False)
    idx_p2 = ivf_add(ivf_remove(idx_p, gone), x_new, use_kernel=False)
    d_u, i_u = ivf_search(idx_u2, q, top_k=5, nprobe=8)
    d_p, i_p = ivf_search(idx_p2, q, top_k=5, nprobe=8)
    np.testing.assert_array_equal(np.asarray(i_u), np.asarray(i_p))
    np.testing.assert_array_equal(np.asarray(d_u), np.asarray(d_p))

    # io round-trip preserves the packed layout (shape-inferred).
    import tempfile, os
    from reductive_tpu import io as rio

    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "ivf_packed.npz")
        rio.save(p, idx_p)
        loaded = rio.load(p)
        assert loaded.packed
        d_l, i_l = ivf_search(loaded, q, top_k=5, nprobe=4)
        d_p, i_p = ivf_search(idx_p, q, top_k=5, nprobe=4)
        np.testing.assert_array_equal(np.asarray(i_l), np.asarray(i_p))

    # Validation: packed requires 4-bit codes.
    from reductive_tpu import train_pq as _tp
    pq8 = _tp(key, x, 4, 8, 2, 1)
    with pytest.raises(ValueError, match="k <= 16"):
        build_ivf(coarse, pq8, x, use_kernel=False, packed=True)


def test_packed_cells_sharded_search():
    """Packed cells shard like unpacked ones (shape-inferred unpack in
    the shared probe core): full-coverage sharded search equals the
    single-device full probe."""
    from reductive_tpu.parallel import make_mesh
    from reductive_tpu.ivf import ivf_search_sharded

    key = jax.random.PRNGKey(54)
    x = clustered_data(key, n_clusters=16, per=60, d=16)
    coarse, pq = train_ivf_pq(key, x, 16, 4, 4, use_kernel=False,
                              train_sample=None)
    idx_p = build_ivf(coarse, pq, x, use_kernel=False, packed=True)
    q = x[::53][:6]
    d_1, i_1 = ivf_search(idx_p, q, top_k=5, nprobe=16, use_kernel=False)
    d_s, i_s = ivf_search_sharded(idx_p, q, top_k=5, nprobe=2,
                                  mesh=make_mesh(), use_kernel=False)
    np.testing.assert_array_equal(np.asarray(i_1), np.asarray(i_s))


def test_device_placement_bit_identical_unbounded():
    """capacity=None builds on device whatever ``placement`` says: each
    row in its nearest cell (numpy reference), cells in corpus order,
    codes bit-identical to the plain residual encode, norms
    ||centroid + recon||^2; a packed build holds the packed codes."""
    import reference_numpy as ref_np
    from reductive_tpu.ops import pack_u4_codes

    key = jax.random.PRNGKey(55)
    x = clustered_data(key, n_clusters=8, per=100, d=16)
    coarse, pq = train_ivf_pq(key, x, 8, 4, 4, use_kernel=False,
                              train_sample=None)
    idx_h = build_ivf(coarse, pq, x, use_kernel=False, placement="host")
    idx_d = build_ivf(coarse, pq, x, use_kernel=False, placement="device",
                      batch=128)
    for f in ("cell_ids", "cell_codes", "cell_norms"):
        np.testing.assert_array_equal(np.asarray(getattr(idx_d, f)),
                                      np.asarray(getattr(idx_h, f)))
    xn, cn = np.asarray(x, np.float64), np.asarray(coarse, np.float64)
    near = np.argmin(ref_np.squared_euclidean_distance(xn, cn), axis=1)
    counts = np.bincount(near, minlength=cn.shape[0])
    ids = np.asarray(idx_d.cell_ids)
    assert ids.shape == (cn.shape[0], counts.max())
    for c in range(cn.shape[0]):
        rows = np.nonzero(near == c)[0]
        np.testing.assert_array_equal(ids[c, : len(rows)], rows)
        assert (ids[c, len(rows):] == -1).all()
        codes = pq.quantize_batch(x[rows] - coarse[c], use_kernel=False)
        np.testing.assert_array_equal(
            np.asarray(idx_d.cell_codes)[c, : len(rows)], np.asarray(codes))
        full = np.asarray(coarse[c] + pq.reconstruct_batch(codes))
        np.testing.assert_allclose(np.asarray(idx_d.cell_norms)[c, : len(rows)],
                                   np.sum(full * full, axis=1), rtol=1e-5)
    idx_dp = build_ivf(coarse, pq, x, use_kernel=False, packed=True)
    np.testing.assert_array_equal(
        np.asarray(idx_dp.cell_codes),
        np.asarray(pack_u4_codes(idx_d.cell_codes.reshape(-1, pq.quantized_len)))
        .reshape(idx_dp.cell_codes.shape))

    with pytest.raises(ValueError, match="placement"):
        build_ivf(coarse, pq, x, use_kernel=False, placement="gpu")


def test_device_placement_bounded_spill_invariants():
    """Bounded device placement: every row stored exactly once, overflow
    spilled to cells with space, stored codes match the storage cell's
    residual encoding; on_overflow="drop"/"error" honored."""
    key = jax.random.PRNGKey(56)
    x = clustered_data(key, n_clusters=4, per=50, d=8, spread=0.3)
    n = x.shape[0]
    coarse, pq = train_ivf_pq(key, x, 4, 2, 3, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, capacity=50, use_kernel=False,
                      placement="device", batch=64)
    assert index.dropped_ids.size == 0
    ids = np.asarray(index.cell_ids)
    flat = ids[ids >= 0]
    assert len(flat) == n and len(set(flat.tolist())) == n

    cells, slots = np.nonzero(ids >= 0)
    rows = ids[cells, slots]
    res = x[rows] - jnp.take(coarse, cells, axis=0)
    expect = np.asarray(pq.quantize_batch(res))
    np.testing.assert_array_equal(
        np.asarray(index.cell_codes)[cells, slots], expect
    )
    # Planted self-queries surface under exact refine (the tiny m=2/k=4
    # quantizer ties near-identical rows; the refine stage breaks them).
    q = x[::41][:6]
    _, i_d = ivf_search(index, q, top_k=3, nprobe=4, use_kernel=False,
                        refine_with=x, refine_factor=24)
    assert (np.asarray(i_d)[:, 0] == np.arange(0, n, 41)[:6]).mean() >= 0.8

    with pytest.raises(ValueError, match="capacity"):
        build_ivf(coarse, pq, x, capacity=40, use_kernel=False,
                  placement="device", on_overflow="error")
    with pytest.raises(ValueError, match="no spill placement"):
        build_ivf(coarse, pq, x, capacity=10, use_kernel=False,
                  placement="device")
    idx_drop = build_ivf(coarse, pq, x, capacity=10, use_kernel=False,
                         placement="device", on_overflow="drop")
    ids2 = np.asarray(idx_drop.cell_ids)
    placed = ids2[ids2 >= 0]
    assert idx_drop.dropped_ids.size == n - len(placed) > 0
    assert (sorted(placed.tolist() + idx_drop.dropped_ids.tolist())
            == list(range(n)))


def test_probe_chunking_matches_unchunked(monkeypatch):
    """Shrinking the probe reconstruction budget to force both chunked
    paths (over probes, then over cell rows) leaves results identical."""
    from reductive_tpu import ivf as ivf_mod

    key = jax.random.PRNGKey(57)
    x = clustered_data(key, n_clusters=8, per=100, d=16)
    coarse, pq = train_ivf_pq(key, x, 8, 4, 4, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, use_kernel=False)
    q = x[::29][:5]
    d_ref, i_ref = ivf_search(index, q, top_k=5, nprobe=4, use_kernel=False)

    # Force probe chunking (pc < nprobe) but one probe still fits.
    nq, L, d = 5, index.capacity, x.shape[1]
    monkeypatch.setattr(ivf_mod, "_PROBE_RECON_BUDGET", nq * L * d * 4)
    ivf_mod._ivf_search_jit.clear_cache()
    d_pc, i_pc = ivf_search(index, q, top_k=5, nprobe=4, use_kernel=False)
    np.testing.assert_array_equal(np.asarray(i_pc), np.asarray(i_ref))
    np.testing.assert_array_equal(np.asarray(d_pc), np.asarray(d_ref))

    # Force cell-row chunking (a single probe exceeds the budget).
    monkeypatch.setattr(ivf_mod, "_PROBE_RECON_BUDGET",
                        max(1, nq * (L // 3) * d * 4))
    ivf_mod._ivf_search_jit.clear_cache()
    d_lc, i_lc = ivf_search(index, q, top_k=5, nprobe=4, use_kernel=False)
    np.testing.assert_array_equal(np.asarray(i_lc), np.asarray(i_ref))
    np.testing.assert_array_equal(np.asarray(d_lc), np.asarray(d_ref))
    ivf_mod._ivf_search_jit.clear_cache()


def test_ivf_add_fast_path_matches_host_path(monkeypatch):
    """The device fast path (every new row fits its nearest cell) places
    rows identically to the host greedy path."""
    from reductive_tpu import ivf as ivf_mod
    from reductive_tpu.ivf import ivf_add, ivf_remove

    key = jax.random.PRNGKey(58)
    x = clustered_data(key, n_clusters=8, per=60, d=16)
    coarse, pq = train_ivf_pq(key, x, 8, 4, 4, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, capacity="auto", use_kernel=False)
    index = ivf_remove(index, np.arange(0, x.shape[0], 7))
    x_new = clustered_data(jax.random.PRNGKey(59), n_clusters=8, per=3,
                           d=16)

    idx_fast = ivf_add(index, x_new, ids=np.arange(9000, 9000 + 24),
                       use_kernel=False)
    # Force the legacy host path and compare.
    real_gate = ivf_mod._add_fast_gate
    monkeypatch.setattr(
        ivf_mod, "_add_fast_gate",
        lambda cell_ids, assign, L: (jnp.asarray(True),
                                     real_gate(cell_ids, assign, L)[1]),
    )
    idx_host = ivf_add(index, x_new, ids=np.arange(9000, 9000 + 24),
                       use_kernel=False)
    np.testing.assert_array_equal(np.asarray(idx_fast.cell_ids),
                                  np.asarray(idx_host.cell_ids))
    np.testing.assert_array_equal(np.asarray(idx_fast.cell_codes),
                                  np.asarray(idx_host.cell_codes))
    np.testing.assert_array_equal(np.asarray(idx_fast.cell_norms),
                                  np.asarray(idx_host.cell_norms))


def test_lut_probe_scoring_matches_decode_path(monkeypatch, interpret_kernels):
    """The LUT (union-of-cells ADC kernel) probe path returns the same
    neighbors and distances as the gather-decode path — including a
    multi-chunk union scan, dot metric, packed cells, and top_k padding
    past the probed candidate count."""
    from reductive_tpu import ivf as ivf_mod
    from reductive_tpu.ivf import _probe_and_score_lut

    key = jax.random.PRNGKey(71)
    x = clustered_data(key, n_clusters=12, per=80, d=16)
    coarse, pq = train_ivf_pq(key, x, 12, 4, 4, use_kernel=False,
                              train_sample=None)

    for packed in (False, True):
        index = build_ivf(coarse, pq, x, capacity="auto",
                          use_kernel=False, packed=packed)
        queries = x[::41][:7] + 0.05 * jax.random.normal(
            jax.random.PRNGKey(72), (7, x.shape[1]))
        for metric in ("l2", "dot"):
            d_ref, i_ref = ivf_search(index, queries, top_k=5, nprobe=4,
                                      use_kernel=False, metric=metric)
            d_lut, i_lut = _probe_and_score_lut(
                queries, index.coarse_centroids, index.cell_codes,
                index.cell_ids, index.cell_norms, index.pq, 4, 5, metric)
            np.testing.assert_array_equal(np.asarray(i_lut),
                                          np.asarray(i_ref))
            np.testing.assert_allclose(np.asarray(d_lut),
                                       np.asarray(d_ref),
                                       rtol=2e-5, atol=2e-5)

    # Multi-chunk union scan (budget forces >1 cell per scan round).
    index = build_ivf(coarse, pq, x, capacity="auto", use_kernel=False)
    queries = x[::29][:9] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(73), (9, x.shape[1]))
    one = _probe_and_score_lut(
        queries, index.coarse_centroids, index.cell_codes, index.cell_ids,
        index.cell_norms, index.pq, 6, 8, "l2")
    monkeypatch.setattr(ivf_mod, "_PROBE_LUT_BUDGET",
                        4 * queries.shape[0] * index.capacity)  # 1 cell/chunk
    many = _probe_and_score_lut(
        queries, index.coarse_centroids, index.cell_codes, index.cell_ids,
        index.cell_norms, index.pq, 6, 8, "l2")
    np.testing.assert_array_equal(np.asarray(one[1]), np.asarray(many[1]))
    np.testing.assert_allclose(np.asarray(one[0]), np.asarray(many[0]),
                               rtol=1e-6)

    # top_k beyond the probed candidate pool pads with +inf / -1.
    small = build_ivf(coarse, pq, x[:24], capacity=4, use_kernel=False,
                      on_overflow="drop")
    d_pad, i_pad = _probe_and_score_lut(
        queries[:3], small.coarse_centroids, small.cell_codes,
        small.cell_ids, small.cell_norms, small.pq, 1, 10, "l2")
    assert d_pad.shape == (3, 10) and i_pad.shape == (3, 10)
    pad_mask = ~np.isfinite(np.asarray(d_pad))
    assert pad_mask.any()
    assert (np.asarray(i_pad)[pad_mask] == -1).all()


def test_device_placement_bounded_respill():
    """placement="device" with a tight capacity: the device respill
    rounds place every overflow row in a cell with space (no drops), no
    cell exceeds L, stored codes are residual encodings against the
    STORAGE cell, and in-capacity rows still sit in their true nearest
    cell."""
    key = jax.random.PRNGKey(83)
    # Skewed cells: clustered data with C much smaller than the cluster
    # count forces real overflow.
    x = clustered_data(key, n_clusters=24, per=50, d=16)
    n = x.shape[0]
    coarse, pq = train_ivf_pq(key, x, 8, 4, 4, use_kernel=False,
                              train_sample=None)
    L = int(np.ceil(1.15 * n / 8))
    index = build_ivf(coarse, pq, x, capacity=L, use_kernel=False,
                      placement="device", on_overflow="spill")

    ids = np.asarray(index.cell_ids)
    valid = ids >= 0
    flat = ids[valid]
    assert index.dropped_ids.size == 0
    assert len(flat) == n and len(set(flat.tolist())) == n
    assert index.capacity == L

    # Every stored code is the residual encoding against its storage
    # cell (spilled rows re-encode against the spill target).
    from reductive_tpu.kmeans import cluster_assignments

    cell_of_row = np.full(n, -1)
    for c in range(ids.shape[0]):
        for l_ in range(ids.shape[1]):
            if ids[c, l_] >= 0:
                cell_of_row[ids[c, l_]] = c
    rows = np.arange(n)[::17]
    res = x[rows] - jnp.take(coarse, cell_of_row[rows], axis=0)
    expect = np.asarray(pq.quantize_batch(res))
    by_row = {int(ids[c, l_]): np.asarray(index.cell_codes)[c, l_]
              for c in range(ids.shape[0]) for l_ in range(ids.shape[1])
              if ids[c, l_] >= 0}
    got = np.stack([by_row[int(r_)] for r_ in rows])
    np.testing.assert_array_equal(got, expect)

    # Rows in non-full cells are in their TRUE nearest cell.
    nearest = np.asarray(cluster_assignments(coarse, x))
    counts = np.bincount(nearest, minlength=8)
    for r_ in rows:
        c = cell_of_row[r_]
        if counts[nearest[r_]] <= L:
            assert c == nearest[r_]


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_ivf_search_kernel_path_sharded(metric, interpret_kernels):
    """ivf_search/ivf_search_sharded with use_kernel=True (the LUT path,
    per shard under shard_map, padded cells masked out of the probes)
    return the decode path's neighbors."""
    from reductive_tpu.parallel import make_mesh

    key = jax.random.PRNGKey(81)
    x = clustered_data(key, n_clusters=13, per=40, d=16)
    coarse, pq = train_ivf_pq(key, x, 13, 4, 4, use_kernel=False,
                              train_sample=None)
    index = build_ivf(coarse, pq, x, capacity="auto", use_kernel=False)
    queries = x[::37][:6] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(82), (6, x.shape[1]))
    d_ref, i_ref = ivf_search(index, queries, top_k=5, nprobe=3,
                              use_kernel=False, metric=metric)
    d_k, i_k = ivf_search(index, queries, top_k=5, nprobe=3,
                          use_kernel=True, metric=metric)
    np.testing.assert_array_equal(np.asarray(i_k), np.asarray(i_ref))
    np.testing.assert_allclose(np.asarray(d_k), np.asarray(d_ref),
                               rtol=2e-5, atol=2e-5)
    mesh = make_mesh(devices=jax.devices()[:4])
    d_sk, i_sk = ivf_search_sharded(index, queries, top_k=5, nprobe=3,
                                    mesh=mesh, use_kernel=True, metric=metric)
    d_sp, i_sp = ivf_search_sharded(index, queries, top_k=5, nprobe=3,
                                    mesh=mesh, use_kernel=False, metric=metric)
    np.testing.assert_array_equal(np.asarray(i_sk), np.asarray(i_sp))
    np.testing.assert_allclose(np.asarray(d_sk), np.asarray(d_sp),
                               rtol=2e-5, atol=2e-5)

"""Cluster-partitioned sharded IVF (``parallel/ivf.py``) on the CPU against
the JAX package's ``parallel/ivf.py`` on its 8-device CPU mesh.

Both packages' IVF indexes are built from the same centroids and
assignments (the reference's k-means), so the layouts are the same and
every table can be compared entry for entry. The port's meshes repeat
the CPU; its scans take their plain versions. The JAX side runs its
Pallas kernels in interpret mode. Tolerances: the cut points, row starts,
padding, dead block, per-shard rows and both block tables equal; scores
within 1e-5 (fp32 sums in another order than the Pallas kernel, as
tests/test_torch_ivf.py) with equal row ids; the port's device plan
bitwise its host plan, and one shard bitwise the single-device IVF.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arxiv_rag_tpu.index.ivf import IVFIndex as JaxIVFIndex
from arxiv_rag_tpu.index.store import build_index as jax_build_index
from arxiv_rag_tpu.ops.kmeans import assign_clusters as jax_assign_clusters
from arxiv_rag_tpu.ops.kmeans import spherical_kmeans as jax_spherical_kmeans
from arxiv_rag_tpu.parallel import data_mesh as jax_data_mesh
from arxiv_rag_tpu.parallel.ivf import ShardedIVF as JaxShardedIVF
from arxiv_rag_tpu.parallel.ivf import partition_clusters as jax_partition_clusters

from arxiv_rag_tpu_torch.config import RetrievalConfig
from arxiv_rag_tpu_torch.index import build_index
from arxiv_rag_tpu_torch.index.ivf import IVFIndex
from arxiv_rag_tpu_torch.ops.topk import cosine_topk_numpy, recall_at_k
from arxiv_rag_tpu_torch.parallel import DeviceMesh, ShardedIVF
from arxiv_rag_tpu_torch.parallel.ivf import partition_clusters
from arxiv_rag_tpu_torch.search import SearchEngine

D, K, BR, QB, NC = 64, 10, 128, 8, 24
TOL = 1e-5
CATEGORIES = ["cs.LG", "cs.CV", "cs.AI"]


def _normalize(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _mesh(nd):
    return DeviceMesh(["cpu"] * nd)


@pytest.fixture(scope="module")
def blob_data():
    """tests/test_sharded_ivf.py's data: 24 blobs of 100 rows, shuffled,
    24 queries near corpus rows, a category per row."""
    rng = np.random.default_rng(13)
    centers = _normalize(rng.standard_normal((NC, D)).astype(np.float32))
    rows = centers[np.repeat(np.arange(NC), 100)]
    rows = _normalize(rows + 0.05 * rng.standard_normal(rows.shape).astype(np.float32))
    rows = rows[rng.permutation(rows.shape[0])]
    queries = _normalize(rows[rng.choice(rows.shape[0], 24)]
                         + 0.1 * rng.standard_normal((24, D)).astype(np.float32))
    cats = rng.choice(CATEGORIES, size=rows.shape[0])
    return rows, queries, cats


@pytest.fixture(scope="module")
def clustering(blob_data):
    rows = blob_data[0]
    cents = jax_spherical_kmeans(rows, NC, iters=8, seed=0, sample_rows=None)
    return cents, jax_assign_clusters(rows, cents)


def _ivf(blob_data, clustering, dtype="float32", cats=False):
    """(port dense, port IVF, JAX dense, JAX IVF) of the same layout."""
    rows, _, c = blob_data
    kw = dict(categories=list(c)) if cats else {}
    cents, assign = clustering
    dense = build_index(rows, dtype=dtype, normalize=False, **kw)
    jdense = jax_build_index(rows, dtype=dtype, normalize=False, **kw)
    ivf = IVFIndex.build(dense, NC, block_rows=BR, centroids=cents, assignments=assign,
                         device="cpu")
    jivf = JaxIVFIndex.build(jdense, NC, block_rows=BR, centroids=cents, assignments=assign)
    return dense, ivf, jdense, jivf


def test_partition_clusters_matches_jax():
    offsets = np.array([0, 10, 10, 40, 45, 100, 160, 200], np.int64)
    cuts = partition_clusters(offsets, 4)
    assert cuts[0] == 0 and cuts[-1] == 7 and (np.diff(cuts) >= 0).all()
    assert np.diff(offsets[cuts]).sum() == 200
    rng = np.random.default_rng(0)
    for nd in range(1, 9):
        for off in (offsets, np.concatenate([[0], np.cumsum(rng.integers(0, 50, 40))])):
            np.testing.assert_array_equal(partition_clusters(off, nd),
                                          jax_partition_clusters(off, nd))


@pytest.mark.parametrize("nd", [1, 2, 4, 8])
def test_layout_and_host_plan_match_jax(blob_data, clustering, nd):
    """Cut points, row starts, padding, the dead block, every shard's rows
    (scales and masks of an int8 index with categories), the device
    planner's expansion table and the host plan's [nd, tiles, width]
    table for JAX's probes: each equal to the JAX package's."""
    queries = blob_data[1]
    _, ivf, _, jivf = _ivf(blob_data, clustering, "int8", cats=True)
    siv, jsiv = ShardedIVF.build(ivf, nd), JaxShardedIVF.build(jivf, nd)
    np.testing.assert_array_equal(siv.cluster_cuts, jsiv.cluster_cuts)
    np.testing.assert_array_equal(siv.row_starts, jsiv.row_starts)
    assert (siv.rows_pad, siv.dead_block) == (jsiv.rows_pad, jsiv.dead_block)
    np.testing.assert_array_equal(siv._shard_cluster_blocks(), jsiv._shard_cluster_blocks())
    mesh, jmesh = _mesh(nd), jax_data_mesh(nd)
    siv.to_device(mesh)
    jsiv.to_device(jmesh)
    for s, shard in enumerate(siv._device["shards"]):
        np.testing.assert_array_equal(shard["values"].numpy(), jsiv.values[s])
        np.testing.assert_array_equal(shard["scales"].numpy(), jsiv.scales[s])
        np.testing.assert_array_equal(shard["masks"].numpy(),
                                      jsiv.row_masks[s].astype(np.int32))
    for nprobe in (3, 4, NC):
        jcids = jsiv.probe(jnp.asarray(queries), nprobe)
        np.testing.assert_array_equal(siv.probe(torch.from_numpy(queries), nprobe), jcids)
        np.testing.assert_array_equal(siv.plan_blocks(jcids, QB), jsiv.plan_blocks(jcids, QB))


@pytest.mark.parametrize("dtype,nd,nprobe,masked,plan", [
    ("float32", 8, NC, False, "host"), ("float32", 8, 4, False, "host"),
    ("int8", 2, NC, False, "host"), ("int8", 8, 4, True, "host"),
    ("float32", 2, 3, False, "device"), ("int8", 8, 4, True, "device")])
def test_search_matches_jax(blob_data, clustering, dtype, nd, nprobe, masked, plan):
    """Results against JAX's sharded route under either plan: the same
    rows, scores within 1e-5; at partial probe too, since the layouts and
    tables are the same."""
    _, queries, _ = blob_data
    dense, ivf, jdense, jivf = _ivf(blob_data, clustering, dtype, cats=masked)
    kw = {}
    if masked:
        kw["query_mask"] = np.full((queries.shape[0],), dense.category_mask(["cs.AI"]))
    jv, jr = JaxShardedIVF.build(jivf, nd).search(queries, K, jax_data_mesh(nd),
                                                  nprobe=nprobe, plan=plan, **kw)
    tv, tr = ShardedIVF.build(ivf, nd).search(torch.from_numpy(queries), K, _mesh(nd),
                                              nprobe=nprobe, plan=plan, **kw)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(tv, jv, atol=TOL)


@pytest.mark.parametrize("nd", [1, 2, 8])
def test_full_probe_matches_flat_oracle(blob_data, clustering, nd):
    rows, queries, _ = blob_data
    siv = ShardedIVF.build(_ivf(blob_data, clustering)[1], nd)
    vals, rids = siv.search(torch.from_numpy(queries), K, _mesh(nd), nprobe=NC)
    ov, oi = cosine_topk_numpy(rows, queries, K)
    assert (rids >= 0).all()
    assert recall_at_k(rids, oi, ov, tie_tol=TOL, candidate_scores=vals) == 1.0
    np.testing.assert_allclose(vals, ov, atol=1e-4)


def test_single_shard_reproduces_single_device(blob_data, clustering):
    """One shard is the single-device layout, tables and all: bitwise."""
    queries = torch.from_numpy(blob_data[1])
    ivf = _ivf(blob_data, clustering)[1]
    sv, sr = ShardedIVF.build(ivf, 1).search(queries, K, _mesh(1), nprobe=4)
    iv, ir = ivf.search(queries, K, nprobe=4)
    np.testing.assert_array_equal(sr, ir)
    np.testing.assert_array_equal(sv, iv)


def test_partial_probe_recall_and_coverage(blob_data, clustering):
    rows, queries, _ = blob_data
    siv = ShardedIVF.build(_ivf(blob_data, clustering)[1], 8)
    mesh = _mesh(8)
    vals, rids = siv.search(torch.from_numpy(queries), K, mesh, nprobe=4)
    ov, oi = cosine_topk_numpy(rows, queries, K)
    assert recall_at_k(rids, oi, ov, tie_tol=1e-4, candidate_scores=vals) >= 0.9
    # every hit comes from the planned coverage of its query tile
    table = siv.plan_blocks(siv.probe(torch.from_numpy(queries), 4), QB)
    starts, br = siv.row_starts, siv.block_rows
    for qi in range(queries.shape[0]):
        covered = set()
        for s in range(8):
            nv = int(starts[s + 1] - starts[s])
            for b in table[s, qi // QB]:
                if b != siv.dead_block:
                    covered.update(int(siv.ivf.perm[starts[s] + r])
                                   for r in range(int(b) * br, min(int(b) * br + br, nv)))
        assert set(rids[qi].tolist()) <= covered


@pytest.mark.parametrize("nd", [2, 8])
def test_int8_full_probe_matches_single_device(blob_data, clustering, nd):
    """The same int8 rows in the same "row" scoring: the sharded full probe
    equals the single-device IVF's."""
    queries = torch.from_numpy(blob_data[1])
    ivf = _ivf(blob_data, clustering, "int8")[1]
    sv, sr = ShardedIVF.build(ivf, nd).search(queries, K, _mesh(nd), nprobe=NC)
    iv, ir = ivf.search(queries, K, nprobe=NC)
    assert recall_at_k(sr, ir, iv, tie_tol=TOL, candidate_scores=sv) == 1.0
    np.testing.assert_allclose(sv, iv, atol=TOL)


def test_masked_sharded_ivf_exact_filter(blob_data, clustering):
    rows, queries, cats = blob_data
    dense, ivf, _, _ = _ivf(blob_data, clustering, "int8", cats=True)
    qmask = np.full((queries.shape[0],), dense.category_mask([CATEGORIES[0]]))
    vals, rids = ShardedIVF.build(ivf, 8).search(torch.from_numpy(queries), K, _mesh(8),
                                                 nprobe=NC, query_mask=qmask)
    eligible = np.flatnonzero(np.asarray(cats) == CATEGORIES[0])
    assert (rids >= 0).all() and np.isin(rids, eligible).all()
    sub_v, sub_i = cosine_topk_numpy(rows[eligible], queries, K)
    assert recall_at_k(rids, eligible[sub_i], sub_v, tie_tol=1e-3,
                       candidate_scores=vals) == 1.0
    with pytest.raises(ValueError, match="row masks"):
        ShardedIVF.build(_ivf(blob_data, clustering)[1], 2).search(
            torch.from_numpy(queries), K, _mesh(2), nprobe=NC, query_mask=qmask)


def test_ragged_query_count(blob_data, clustering):
    rows, queries, _ = blob_data
    siv = ShardedIVF.build(_ivf(blob_data, clustering)[1], 8)
    vals, rids = siv.search(torch.from_numpy(queries[:5]), K, _mesh(8), nprobe=NC)
    assert vals.shape == (5, K) and rids.shape == (5, K)
    ov, oi = cosine_topk_numpy(rows, queries[:5], K)
    assert recall_at_k(rids, oi, ov, tie_tol=TOL, candidate_scores=vals) == 1.0
    with pytest.raises(ValueError, match="shards"):  # the layout is for 8 shards
        siv.search(torch.from_numpy(queries), K, _mesh(4), nprobe=NC)


@pytest.mark.parametrize("nd", [1, 2, 8])
def test_device_plan_matches_host_plan_sharded(blob_data, clustering, nd):
    """plan="device" (each shard probes and plans on its device) covers the
    same rows per shard as the host planner: bitwise, f32 and int8, full
    and partial probe."""
    queries = torch.from_numpy(blob_data[1])
    for dtype in ("float32", "int8"):
        siv = ShardedIVF.build(_ivf(blob_data, clustering, dtype)[1], nd)
        for nprobe in (3, NC):
            hv, hr = siv.search(queries, K, _mesh(nd), nprobe=nprobe, plan="host")
            dv, dr = siv.search(queries, K, _mesh(nd), nprobe=nprobe, plan="device")
            np.testing.assert_array_equal(dr, hr, err_msg=f"{dtype} nd={nd} np={nprobe}")
            np.testing.assert_array_equal(dv, hv)
    with pytest.raises(ValueError, match="plan"):
        siv.search(queries, K, _mesh(nd), nprobe=3, plan="both")


def test_device_plan_masked_sharded(blob_data, clustering):
    queries = blob_data[1]
    dense, ivf, _, _ = _ivf(blob_data, clustering, "int8", cats=True)
    siv = ShardedIVF.build(ivf, 8)
    qmask = np.full((queries.shape[0],), dense.category_mask(["cs.AI"]))
    hv, hr = siv.search(torch.from_numpy(queries), K, _mesh(8), nprobe=NC, query_mask=qmask,
                        plan="host")
    dv, dr = siv.search(torch.from_numpy(queries), K, _mesh(8), nprobe=NC, query_mask=qmask,
                        plan="device")
    np.testing.assert_array_equal(dr, hr)
    np.testing.assert_array_equal(dv, hv)


@pytest.mark.parametrize("plan", ["device", "host"])
def test_engine_mesh_routes_through_sharded_ivf(blob_data, clustering, plan):
    """A mesh-sharded engine with an IVF index and nprobe > 0 serves through
    the cluster-partitioned route, equal to the single-device engine's
    IVF at full probe, with and without a category filter."""
    rows, queries, cats = blob_data
    cfg = RetrievalConfig(nprobe=NC, ivf_plan=plan)
    dense, ivf, _, _ = _ivf(blob_data, clustering, "int8", cats=True)
    single = SearchEngine(dense, ivf=ivf, cfg=cfg, device="cpu")
    dense2, ivf2, _, _ = _ivf(blob_data, clustering, "int8", cats=True)
    dense2.to_device(mesh=_mesh(8), row_multiple=BR)
    meshed = SearchEngine(dense2, ivf=ivf2, cfg=cfg)
    assert ivf2._device_cb is None  # no single-device placement on a mesh
    for kw in ({}, {"categories": ["cs.CV"]}):
        sv, sr = single.search_embeddings(queries, K, **kw)
        mv, mr = meshed.search_embeddings(queries, K, **kw)
        assert meshed._sharded_ivf_cache is not None  # routed through the mesh layout
        assert recall_at_k(mr, sr, sv, tie_tol=TOL, candidate_scores=mv) == 1.0
        np.testing.assert_allclose(mv, sv, atol=TOL)
    assert np.isin(mr, np.flatnonzero(np.asarray(cats) == "cs.CV")).all()

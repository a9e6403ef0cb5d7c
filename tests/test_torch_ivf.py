"""IVF (cluster-pruned) retrieval on the CPU against the JAX reference:
k-means, the block tables and both planners, the pruned scans (K5, K6
as plain versions), ``IVFIndex``, its on-disk delta in both directions,
the engine's IVF route and the CLI.

The JAX kernels run in Pallas interpret mode, as tests/test_ivf.py runs
them. Both packages' IVF indexes are built from the same centroids and
assignments, so a k-means difference cannot cascade into the scans;
k-means is held against the reference on its own. Tolerances: scores
within 1e-5 (fp32 sums in another order); where ids can differ only by
such sums, tie-tolerant recall 1.0 at 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arxiv_rag_tpu.config import RetrievalConfig as JaxRetrievalConfig
from arxiv_rag_tpu.index.ivf import IVFIndex as JaxIVFIndex
from arxiv_rag_tpu.index.store import build_index as jax_build_index
from arxiv_rag_tpu.ops.kmeans import assign_clusters as jax_assign_clusters
from arxiv_rag_tpu.ops.kmeans import spherical_kmeans as jax_spherical_kmeans
from arxiv_rag_tpu.ops.pallas_ivf import _device_plan as jax_device_plan
from arxiv_rag_tpu.ops.pallas_ivf import cluster_block_table as jax_cluster_block_table
from arxiv_rag_tpu.ops.pallas_ivf import ivf_topk as jax_ivf_topk
from arxiv_rag_tpu.ops.pallas_ivf import ivf_topk_int8 as jax_ivf_topk_int8
from arxiv_rag_tpu.search import SearchEngine as JaxSearchEngine

from arxiv_rag_tpu_torch.config import RetrievalConfig
from arxiv_rag_tpu_torch.index import build_index
from arxiv_rag_tpu_torch.index.ivf import IVFIndex
from arxiv_rag_tpu_torch.ops import fused_topk as ft
from arxiv_rag_tpu_torch.ops import ivf as oivf
from arxiv_rag_tpu_torch.ops.kmeans import assign_clusters, spherical_kmeans
from arxiv_rag_tpu_torch.ops.topk import recall_at_k
from arxiv_rag_tpu_torch.search import SearchEngine

D, K, BR, QB, C = 64, 10, 128, 8, 24
TOL = 1e-5
CATEGORIES = ["cs.LG", "cs.CV", "cs.AI"]


def _normalize(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


@pytest.fixture(scope="module")
def blob_data():
    """24 well-separated blobs of 100 rows (as tests/test_ivf.py), 4 rows
    duplicated exactly so that ties occur, shuffled; 21 queries near
    corpus rows (a ragged count: not a multiple of q_block)."""
    rng = np.random.default_rng(7)
    centers = _normalize(rng.standard_normal((C, D)).astype(np.float32))
    rows = centers[np.repeat(np.arange(C), 100)]
    rows = _normalize(rows + 0.05 * rng.standard_normal(rows.shape).astype(np.float32))
    rows = np.concatenate([rows, rows[[5, 300, 301, 1700]]])
    index = rows[rng.permutation(rows.shape[0])]
    queries = _normalize(index[rng.choice(index.shape[0], 21)]
                         + 0.1 * rng.standard_normal((21, D)).astype(np.float32))
    queries[7] = index[np.flatnonzero((index == rows[300]).all(axis=1))[0]]  # a tie at the top
    cats = rng.choice(CATEGORIES, size=index.shape[0])
    return index, queries, cats


@pytest.fixture(scope="module")
def clustering(blob_data):
    """Centroids and assignments from the reference, shared by both
    packages' IVF builds."""
    index, _, _ = blob_data
    cents = jax_spherical_kmeans(index, C, iters=8, seed=0, sample_rows=None)
    return cents, jax_assign_clusters(index, cents)


def _pair(blob_data, clustering, dtype, with_cats=False):
    index, _, cats = blob_data
    cents, assign = clustering
    kw = dict(categories=cats) if with_cats else {}
    jdense = jax_build_index(index, dtype=dtype, normalize=False, **kw)
    dense = build_index(index, dtype=dtype, normalize=False, **kw)
    jivf = JaxIVFIndex.build(jdense, C, block_rows=BR, centroids=cents, assignments=assign)
    ivf = IVFIndex.build(dense, C, block_rows=BR, centroids=cents, assignments=assign,
                         device="cpu")
    return jdense, dense, jivf, ivf


def _bits(t, dtype):
    a = t.cpu()
    return a.view(torch.int16).numpy() if dtype == "bfloat16" else a.numpy()


def _jbits(a, dtype):
    a = np.asarray(a)
    return a.view(np.int16) if dtype == "bfloat16" else a


# -- k-means ---------------------------------------------------------------------


def test_kmeans_matches_jax(blob_data):
    """Same draws, same bf16 products: centroids within 1e-5 (fp32 sums
    and norms in another order), assignments equal on the blobs; the
    sampled path and the empty-cluster reseed take the same rows."""
    index, _, _ = blob_data
    jc = jax_spherical_kmeans(index, C, iters=8, seed=0, sample_rows=None)
    tc = spherical_kmeans(torch.from_numpy(index), C, iters=8, seed=0, sample_rows=None)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-5)
    np.testing.assert_array_equal(assign_clusters(torch.from_numpy(index), tc).numpy(),
                                  jax_assign_clusters(index, jc))
    # 2 tight blobs, 8 clusters: empty clusters are reseeded; and a sample
    rng = np.random.default_rng(0)
    two = _normalize(np.repeat(_normalize(rng.standard_normal((2, D))), 50, axis=0)
                     + 0.02 * rng.standard_normal((100, D))).astype(np.float32)
    for kw in (dict(sample_rows=None), dict(sample_rows=60)):
        jc = jax_spherical_kmeans(two, 8, iters=6, seed=1, **kw)
        tc = spherical_kmeans(torch.from_numpy(two), 8, iters=6, seed=1, **kw)
        np.testing.assert_allclose(tc.numpy(), jc, atol=1e-5)


# -- block tables and planners ----------------------------------------------------


def test_cluster_block_table_matches_jax(blob_data, clustering):
    _, _, jivf, ivf = _pair(blob_data, clustering, "float32")
    np.testing.assert_array_equal(ivf.offsets, jivf.offsets)
    for offsets, br, dead in ((ivf.offsets, BR, ivf.dead_block), (ivf.offsets, 64, 99),
                              (np.array([0, 0, 5, 5, 300, 301]), 128, 99)):
        np.testing.assert_array_equal(oivf.cluster_block_table(offsets, br, dead),
                                      jax_cluster_block_table(offsets, br, dead))


def test_planners_match_jax_on_the_same_probes(blob_data, clustering):
    """``plan_blocks`` (host) and ``device_plan`` bitwise equal to the
    reference's on the same probe ids; the device plan lists the host
    plan's blocks, then dead ids."""
    _, _, jivf, ivf = _pair(blob_data, clustering, "float32")
    rng = np.random.default_rng(3)
    cids = rng.integers(0, C, (24, 5)).astype(np.int32)
    cids[:8] = cids[0]  # a tile whose queries share their probes
    host = ivf.plan_blocks(cids, QB)
    np.testing.assert_array_equal(host, jivf.plan_blocks(cids, QB))
    cb = oivf.cluster_block_table(ivf.offsets, BR, ivf.dead_block)
    width = oivf.device_table_width(ivf.n_blocks, cb.shape[1], 5, QB)
    dev = oivf.device_plan(torch.from_numpy(cids).long(), torch.from_numpy(cb),
                           ivf.dead_block, QB, width)
    want = jax_device_plan(jnp.asarray(cids), jnp.asarray(cb), ivf.dead_block, QB, width)
    np.testing.assert_array_equal(dev.numpy(), np.asarray(want))
    for t in range(3):
        real = dev[t][dev[t] != ivf.dead_block].numpy()
        np.testing.assert_array_equal(real, host[t][host[t] != ivf.dead_block])


def _table_work(table, n_valid: int, block_rows: int, n_splits: int) -> list[list[list]]:
    """The block-table kernel's division of work, modelled on the host
    line for line after ``csrc/fused_topk.cu::tb_item_row`` and the
    kernel's split: ``[tile][split]`` lists of (block, first row) items,
    128-row slices of the tile's entries up to its last real visit (a
    block that starts below ``n_valid``), evenly over the splits, in
    table order; a dead visit or a slice wholly past n_valid loads
    nothing."""
    per_visit = -(-block_rows // ft.TABLE_ROWS)
    out = []
    for row in [list(map(int, r)) for r in table]:
        real = [v for v, b in enumerate(row) if b >= 0 and b * block_rows < n_valid]
        items = (real[-1] + 1 if real else 0) * per_visit
        per_split = -(-items // n_splits)
        splits = []
        for sp in range(n_splits):
            lo = min(items, sp * per_split)
            work = []
            for it in range(lo, min(items, lo + per_split)):
                blk = row[it // per_visit]
                r0 = blk * block_rows + (it % per_visit) * ft.TABLE_ROWS
                if blk >= 0 and r0 < n_valid:
                    work.append((blk, r0))
            splits.append(work)
        out.append(splits)
    return out


@pytest.mark.parametrize("plan", ["host", "device"])
@pytest.mark.parametrize("q_block", [8, 16])
@pytest.mark.parametrize("block_rows", [128, 192, 1024])
def test_table_work_gives_each_real_slice_to_one_split(blob_data, clustering, block_rows,
                                                       q_block, plan):
    """The block-table kernel's division of work (``_table_work``, its
    host model) on the planners' tables, with
    ``plan_table``'s split count at the serving card's 132 SMs, 1 and 2
    blocks each, and on a row of dead visits only: every 128-row slice of
    every real visit (below n_valid) goes to exactly one split of its
    tile, no slice of a dead visit to any, and no split gets more than
    its even share."""
    index, queries, _ = blob_data
    cents, assign = clustering
    dense = build_index(index, dtype="float32", normalize=False)
    ivf = IVFIndex.build(dense, C, block_rows=block_rows, centroids=cents,
                         assignments=assign, device="cpu")
    cids = ivf.probe(np.resize(queries, (2 * q_block, D)), 6)
    if plan == "host":
        table = ivf.plan_blocks(cids, q_block)
    else:
        cb = oivf.cluster_block_table(ivf.offsets, block_rows, ivf.dead_block)
        width = oivf.device_table_width(ivf.n_blocks, cb.shape[1], 6, q_block)
        table = oivf.device_plan(torch.from_numpy(cids).long(), torch.from_numpy(cb),
                                 ivf.dead_block, q_block, width).numpy()
    table = np.concatenate([table, np.full((1, table.shape[1]), ivf.dead_block, np.int32)])
    per_visit = -(-block_rows // ft.TABLE_ROWS)
    for blocks_per_sm in (1, 2):
        n_splits = ft.plan_table(table.shape[1], table.shape[0], per_visit, 132, blocks_per_sm)
        assert 1 <= n_splits <= table.shape[1] * per_visit
        work = _table_work(table, ivf.n_valid, block_rows, n_splits)
        assert len(work) == table.shape[0]
        for row, splits in zip(table, work):
            real = [int(b) for b in row if b != ivf.dead_block]
            assert all(b * block_rows < ivf.n_valid for b in real)
            want = sorted((b, b * block_rows + s * ft.TABLE_ROWS) for b in real
                          for s in range(per_visit)
                          if b * block_rows + s * ft.TABLE_ROWS < ivf.n_valid)
            got = [item for split in splits for item in split]
            assert sorted(got) == want  # each once, none dead
            assert len(splits) == n_splits
            share = -(-len(real) * per_visit // n_splits)
            assert max(len(split) for split in splits) <= share
        assert work[-1] == [[] for _ in range(n_splits)]  # the all-dead row


def test_table_scan_plain_matches_jax_kernel(blob_data, clustering):
    """K5's plain version against the Pallas kernel on the same tables
    (f32 and int8 row variant), dead padding included, and a last tile
    whose row lists only the dead block: (-inf, -1) from both."""
    _, _, jivf, ivf = _pair(blob_data, clustering, "float32")
    _, _, jivf8, ivf8 = _pair(blob_data, clustering, "int8")
    _, queries, _ = blob_data
    q = np.concatenate([queries[:2 * QB], queries[:QB]])
    table = ivf.plan_blocks(ivf.probe(q, 4), QB)
    table[-1] = ivf.dead_block
    tv, ti = oivf.ivf_topk(ivf.values, table, torch.from_numpy(q), K,
                           n_valid=ivf.n_valid, block_rows=BR)
    jv, ji = jax_ivf_topk(jnp.asarray(jivf.values), table, jnp.asarray(q), K,
                          n_valid=ivf.n_valid, block_rows=BR, interpret=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (tv[-QB:] == -np.inf).all() and (ti[-QB:] == -1).all()
    tv, ti = oivf.ivf_topk_int8(ivf8.values, ivf8.scales, table, torch.from_numpy(q), K,
                                n_valid=ivf.n_valid, block_rows=BR)
    jv, ji = jax_ivf_topk_int8(jnp.asarray(jivf8.values), jnp.asarray(jivf8.scales), table,
                               jnp.asarray(q), K, n_valid=ivf.n_valid, block_rows=BR,
                               interpret=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)
    np.testing.assert_array_equal(ti[-QB:].numpy(), np.asarray(ji)[-QB:])
    assert (tv[-QB:] == -np.inf).all() and (ti[-QB:] == -1).all()
    assert recall_at_k(ti[:-QB].numpy(), np.asarray(ji)[:-QB], np.asarray(jv)[:-QB],
                       tie_tol=TOL, candidate_scores=tv[:-QB].numpy()) == 1.0


def test_table_plain_refuses_duplicate_or_unsorted_blocks(blob_data, clustering):
    _, _, _, ivf = _pair(blob_data, clustering, "float32")
    q = torch.from_numpy(blob_data[1][:8])
    for row in ([0, 2, 2, ivf.dead_block], [3, 1, ivf.dead_block, ivf.dead_block]):
        with pytest.raises(ValueError, match="once, ascending"):
            oivf.ivf_topk(ivf.values, np.array([row], np.int32), q, K,
                          n_valid=ivf.n_valid, block_rows=BR)


# -- IVFIndex --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_ivf_build_matches_jax(blob_data, clustering, dtype):
    """The layout from the same centroids and assignments is bitwise the
    reference's: perm, offsets, values, scales, row masks, dead block."""
    _, _, jivf, ivf = _pair(blob_data, clustering, dtype, with_cats=True)
    np.testing.assert_array_equal(ivf.perm, jivf.perm)
    np.testing.assert_array_equal(_bits(ivf.values, dtype), _jbits(jivf.values, dtype))
    np.testing.assert_array_equal(ivf.row_masks.numpy(), jivf.row_masks.view(np.int32))
    if dtype == "int8":
        np.testing.assert_array_equal(ivf.scales.numpy(), jivf.scales)
    assert (ivf.dead_block, ivf.n_blocks, ivf.n_valid) == (jivf.dead_block, jivf.n_blocks,
                                                            jivf.n_valid)


@pytest.mark.parametrize("plan", ["host", "device"])
@pytest.mark.parametrize("dtype,masked", [("float32", False), ("bfloat16", False),
                                          ("int8", False), ("float32", True),
                                          ("int8", True)])
def test_ivf_search_matches_jax(blob_data, clustering, dtype, masked, plan):
    """``IVFIndex.search`` against the reference's on a ragged query count
    (21, padded by repeating the last query), nprobe 6 of 24."""
    _, queries, _ = blob_data
    jdense, _, jivf, ivf = _pair(blob_data, clustering, dtype, with_cats=True)
    kw = {}
    if masked:
        kw["query_mask"] = np.full((queries.shape[0],), jdense.category_mask(["cs.CV"]))
    jv, jr = jivf.search(queries, K, nprobe=6, q_block=QB, interpret=True, plan=plan, **kw)
    tv, tr = ivf.search(queries, K, nprobe=6, q_block=QB, plan=plan, **kw)
    assert tv.shape == (21, K) and tr.dtype == np.int64
    np.testing.assert_allclose(tv, jv, atol=TOL)
    assert recall_at_k(tr, jr, jv, tie_tol=TOL, candidate_scores=tv) == 1.0


def test_device_plan_equals_host_plan(blob_data, clustering):
    """The device planner covers the host planner's rows: equal results
    (same plain scan of the same rows), f32, int8 and masked."""
    _, queries, _ = blob_data
    for dtype in ("float32", "int8"):
        _, _, _, ivf = _pair(blob_data, clustering, dtype, with_cats=True)
        qmask = np.full((queries.shape[0],), np.uint32(0b010))  # cs.CV
        for nprobe, kw in ((2, {}), (5, {}), (C, {}), (5, {"query_mask": qmask})):
            hv, hr = ivf.search(queries, K, nprobe=nprobe, plan="host", **kw)
            dv, dr = ivf.search(queries, K, nprobe=nprobe, plan="device", **kw)
            np.testing.assert_array_equal(dr, hr)
            np.testing.assert_array_equal(dv, hv)


def test_full_probe_equals_flat_scan_of_ivf_order(blob_data, clustering):
    """nprobe = all clusters equals the flat scan of the same IVF-ordered
    values, ids included, exact ties included (duplicated rows: the lower
    IVF id wins on both sides); only then are ids mapped through perm."""
    _, queries, _ = blob_data
    for dtype in ("float32", "int8"):
        _, _, _, ivf = _pair(blob_data, clustering, dtype)
        q = torch.from_numpy(queries[:16])
        cb = torch.from_numpy(oivf.cluster_block_table(ivf.offsets, BR, ivf.dead_block))
        kw = dict(scales=ivf.scales) if dtype == "int8" else {}
        iv, ii = oivf.ivf_topk_device(ivf.values, cb, torch.from_numpy(ivf.centroids), q, K,
                                      nprobe=C, n_valid=ivf.n_valid, block_rows=BR, **kw)
        if dtype == "int8":
            fv, fi = ft.fused_topk_int8(ivf.values, ivf.scales, q, K, n_valid=ivf.n_valid,
                                        variant="row")
        else:
            fv, fi = ft.fused_topk(ivf.values, q, K, n_valid=ivf.n_valid)
        np.testing.assert_array_equal(ii.numpy(), fi.numpy())
        np.testing.assert_allclose(iv.numpy(), fv.numpy(), atol=1e-6)
        tied = fv.numpy()[7, 0] == fv.numpy()[7, 1]
        assert tied and fi[7, 0] < fi[7, 1]  # query 7 is a duplicated row
        _, rows = ivf.search(queries[:16], K, nprobe=C)
        np.testing.assert_array_equal(rows, ivf.perm[fi.numpy()])


def test_delta_loads_in_either_package(blob_data, clustering, tmp_path):
    """The delta format is shared: a port-saved delta loads in the
    reference and vice versa, with the same layout and answers."""
    _, queries, _ = blob_data
    jdense, dense, jivf, ivf = _pair(blob_data, clustering, "int8", with_cats=True)
    ivf.save(tmp_path / "ours")
    jivf.save(tmp_path / "theirs")
    assert IVFIndex.exists(tmp_path / "ours") and JaxIVFIndex.exists(tmp_path / "ours")
    assert json.loads((tmp_path / "ours/ivf/meta.json").read_text()) == \
        json.loads((tmp_path / "theirs/ivf/meta.json").read_text())
    jl = JaxIVFIndex.load(tmp_path / "ours", jdense)
    tl = IVFIndex.load(tmp_path / "theirs", dense, device="cpu")
    for a, b in ((tl, jl), (tl, jivf)):
        np.testing.assert_array_equal(a.perm, b.perm)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.centroids, b.centroids)
        np.testing.assert_array_equal(a.values.numpy(), np.asarray(b.values))
    v1, r1 = tl.search(queries, K, nprobe=6)
    v2, r2 = ivf.search(queries, K, nprobe=6)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(v1, v2)
    with pytest.raises(ValueError, match="rebuild"):
        IVFIndex.load(tmp_path / "ours", build_index(blob_data[0][:500], dtype="int8"),
                      device="cpu")
    # extend with no new rows: the same layout, in either package, from
    # either package's delta
    for d in ("ours", "theirs"):
        ext = IVFIndex.extend(tmp_path / d, dense, device="cpu")
        jext = JaxIVFIndex.extend(tmp_path / d, jdense)
        for a in (ext, jext):
            np.testing.assert_array_equal(a.perm, ivf.perm)
            np.testing.assert_array_equal(a.offsets, ivf.offsets)
        np.testing.assert_array_equal(ext.values.numpy(), ivf.values.numpy())


# -- the engine's IVF route -------------------------------------------------------


@pytest.mark.parametrize("plan", ["device", "host"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_engine_ivf_route_matches_jax(blob_data, clustering, dtype, plan):
    """``search_embeddings`` with an IVF attached (nprobe 6), with and
    without a category filter, against the JAX engine."""
    _, queries, _ = blob_data
    jdense, dense, jivf, ivf = _pair(blob_data, clustering, dtype, with_cats=True)
    jeng = JaxSearchEngine(jdense, ivf=jivf, use_pallas=True,
                           cfg=JaxRetrievalConfig(nprobe=6, ivf_plan=plan))
    eng = SearchEngine(dense, ivf=ivf, device="cpu",
                       cfg=RetrievalConfig(nprobe=6, ivf_plan=plan))
    for cats in (None, ["cs.AI"]):
        jv, jr = (np.asarray(a) for a in jeng.search_embeddings(queries, K, cats))
        tv, tr = eng.search_embeddings(queries, K, cats)
        np.testing.assert_allclose(tv, jv, atol=TOL)
        assert recall_at_k(tr, jr, jv, tie_tol=TOL, candidate_scores=tv) == 1.0
    # nprobe=0 per call: the exact flat route
    fv, fr = eng.search_embeddings(queries, K, nprobe=0)
    jfv, jfr = (np.asarray(a) for a in jeng.search_embeddings(queries, K, nprobe=0))
    assert recall_at_k(fr, jfr, jfv, tie_tol=TOL, candidate_scores=fv) == 1.0


def test_engine_k_over_128_falls_back_to_flat(blob_data, clustering):
    index, queries, _ = blob_data
    _, dense, _, ivf = _pair(blob_data, clustering, "float32")
    eng = SearchEngine(dense, ivf=ivf, device="cpu", cfg=RetrievalConfig(nprobe=2))
    vals, rows = eng.search_embeddings(queries[:4], 200)
    assert vals.shape == (4, 200)
    want = np.argsort(-(queries[:4] @ index.T), axis=1, kind="stable")[:, :200]
    np.testing.assert_array_equal(rows, want)


# -- CLI -------------------------------------------------------------------------


def _embed_dir(tmp_path, vectors):
    d = tmp_path / "emb"
    d.mkdir()
    np.save(d / "embeddings-00000.npy", vectors)
    (d / "ids_00000.json").write_text(json.dumps([f"c{i}" for i in range(len(vectors))]))
    (d / "index.json").write_text(json.dumps(
        {"dim": vectors.shape[1], "batches": [{"file": "embeddings-00000.npy",
                                                "rows": len(vectors)}]}))
    return d


def test_cli_index_ivf_then_search_nprobe_categories(tmp_path, capsys):
    """`index --ivf-clusters` writes the delta; `search --nprobe
    --categories` on the CPU answers what the engine answers."""
    from types import SimpleNamespace

    from arxiv_rag_tpu_torch.cli.main import build_engine, main

    rng = np.random.default_rng(1)
    vectors = _normalize(rng.standard_normal((400, 768))).astype(np.float32)
    emb = _embed_dir(tmp_path, vectors)
    base = ["index", "--embeddings", str(emb), "--device", "cpu", "--ivf-clusters", "8"]
    assert main(base + ["--out", str(tmp_path / "bad"), "--ivf-block-rows", "100"]) == 2
    assert main(base + ["--out", str(tmp_path / "idx"), "--ivf-block-rows", "128",
                        "--ivf-iters", "3"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ivf_clusters"] == 8 and out["ivf_block_rows"] == 128
    assert IVFIndex.exists(tmp_path / "idx") and JaxIVFIndex.exists(tmp_path / "idx")
    # --append extends the existing delta with its centroids: asking for a
    # cluster count as well is refused before anything is written
    manifest = (tmp_path / "idx" / "index.json").read_text()
    assert main(["index", "--embeddings", str(emb), "--device", "cpu", "--append",
                 "--ivf-clusters", "4", "--out", str(tmp_path / "idx")]) == 2
    assert "already has an IVF delta" in capsys.readouterr().err
    assert (tmp_path / "idx" / "index.json").read_text() == manifest

    # an index with categories (the CLI reads them from a corpus in a later
    # slice), its delta built by the library
    cats = np.array(CATEGORIES)[rng.integers(0, 3, 400)]
    idx = build_index(vectors, categories=cats, dtype="int8")
    idx.save(tmp_path / "cat")
    IVFIndex.build(idx, 8, block_rows=128, iters=3, device="cpu").save(tmp_path / "cat")
    args = ["--index", str(tmp_path / "cat"), "--device", "cpu", "--nprobe", "4"]
    assert main(["search", *args, "--query", "graph kernels", "--k", "5",
                 "--categories", "cs.CV,cs.AI"]) == 0
    printed = [line for line in capsys.readouterr().out.splitlines() if "row=" in line]
    rows = [int(line.split("row=")[1]) for line in printed]
    engine = build_engine(SimpleNamespace(index=str(tmp_path / "cat"), checkpoint=None,
                                          vocab=None, device="cpu", nprobe=4))
    assert engine.ivf is not None and engine.cfg.nprobe == 4
    want = engine.search(["graph kernels"], k=5, categories=["cs.CV", "cs.AI"])[0]
    assert rows == [h.row for h in want] and len(rows) == 5
    assert all(cats[r] in ("cs.CV", "cs.AI") for r in rows)

"""Row-sharded flat search (``parallel/``) on the CPU against the JAX
package's ``parallel/`` on its 8-device CPU mesh (tests/conftest.py).

The port's meshes repeat the CPU (``DeviceMesh(["cpu"] * nd)``), the
counterpart of XLA's forced host device count; its wrappers take their
plain versions for CPU tensors, and its merge is a stable sort. The JAX
side runs its Pallas kernels in interpret mode inside ``shard_map``
(``use_pallas=True``), the TPU route, whose int8 default is s8s8.
Tolerances: s8s8 (masked or not) bitwise; the float kinds (f32, bf16 and
the int8 "row" mode, masked or not) sum fp32 products in another order
than the Pallas kernel: equal ids, scores within 1e-5, as the
single-device port tests hold them (tests/test_torch_ops.py,
tests/test_torch_masked.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arxiv_rag_tpu.index.store import build_index as jax_build_index
from arxiv_rag_tpu.ops.quant import quantize_int8 as jax_quantize_int8
from arxiv_rag_tpu.parallel import data_mesh as jax_data_mesh
from arxiv_rag_tpu.parallel import shard_index_rows as jax_shard_index_rows
from arxiv_rag_tpu.parallel import sharded_topk as jax_sharded_topk
from arxiv_rag_tpu.search import SearchEngine as JaxSearchEngine

from arxiv_rag_tpu_torch.index import build_index
from arxiv_rag_tpu_torch.ops import fused_topk as ft
from arxiv_rag_tpu_torch.ops.quant import quantize_int8
from arxiv_rag_tpu_torch.ops.topk import cosine_topk_numpy, recall_at_k
from arxiv_rag_tpu_torch.parallel import (
    DeviceMesh,
    data_mesh,
    replicate,
    shard_index_rows,
    sharded_topk,
)
from arxiv_rag_tpu_torch.search import SearchEngine

N, D, Q, K = 4100, 64, 16, 10  # N deliberately not divisible by 8
TOL = 1e-5
KINDS = ["f32", "bf16", "s8s8", "row", "masked f32", "masked bf16", "masked s8s8",
         "masked row"]
EXACT = ("s8s8", "masked s8s8")


def _normalize(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    index = _normalize(rng.standard_normal((N, D), dtype=np.float32))
    queries = _normalize(rng.standard_normal((Q, D), dtype=np.float32))
    codes = rng.integers(0, 32, N).astype(np.uint32)
    row_masks = (np.uint32(1) << codes).view(np.int32)
    qmask = rng.integers(1, 2**32, Q, dtype=np.uint64).astype(np.uint32)
    qmask[0] = 0  # matches nothing: every slot empty
    qmask[1] = np.uint32(1 << 31)  # category 31 only: the int32 sign bit
    qmask[2] = np.uint32(0xFFFFFFFF)
    return index, queries, row_masks, qmask.view(np.int32)


_JAX: dict = {}  # (kind, nd, k, use_pallas) -> JAX's result: each is compiled once


def _jax_sharded(kind, nd, data, k=K, use_pallas=True):
    key = (kind, nd, k, use_pallas)
    if key not in _JAX:
        _JAX[key] = _jax_sharded_run(kind, nd, data, k, use_pallas)
    return _JAX[key]


def _jax_sharded_run(kind, nd, data, k, use_pallas):
    index, queries, row_masks, qmask = data
    mesh = jax_data_mesh(nd)
    base = kind.removeprefix("masked ")
    kw = {}
    if base in ("s8s8", "row"):
        jq, js = jax_quantize_int8(jnp.asarray(index))
        values = np.asarray(jq)
        s, _ = jax_shard_index_rows(np.asarray(js).reshape(-1, 1), mesh)
        kw.update(scales=s.reshape(-1), int8_variant=base)
    else:
        values = np.asarray(jnp.asarray(index, jnp.bfloat16 if base == "bf16" else jnp.float32))
    shards, n = jax_shard_index_rows(values, mesh)
    if kind.startswith("masked"):
        rm, _ = jax_shard_index_rows(row_masks.reshape(-1, 1), mesh)
        kw.update(row_masks=rm.reshape(-1), query_mask=jnp.asarray(qmask))
    v, g = jax_sharded_topk(shards, jnp.asarray(queries), k, mesh, n_valid=n,
                            use_pallas=use_pallas, interpret=True if use_pallas else None, **kw)
    return np.asarray(v), np.asarray(g)


def _port_sharded(kind, nd, data, k=K):
    index, queries, row_masks, qmask = data
    mesh = DeviceMesh(["cpu"] * nd)
    base = kind.removeprefix("masked ")
    kw = {}
    if base in ("s8s8", "row"):
        values, scales = quantize_int8(_t(index))
        kw.update(scales=shard_index_rows(scales, mesh)[0], int8_variant=base)
    else:
        values = _t(index).to(torch.bfloat16 if base == "bf16" else torch.float32)
    shards, n = shard_index_rows(values, mesh)
    if kind.startswith("masked"):
        kw.update(row_masks=shard_index_rows(row_masks, mesh)[0], query_mask=_t(qmask))
    v, g = sharded_topk(shards, _t(queries), k, mesh, n_valid=n, **kw)
    assert v.dtype == torch.float32 and g.dtype == torch.int32 and v.shape == (Q, k)
    return v.numpy(), g.numpy()


def test_eight_device_meshes():
    assert len(jax.devices()) == 8  # the reference's simulation mesh
    mesh = DeviceMesh(["cpu"] * 8)
    assert mesh.size == 8 and set(mesh.devices) == {torch.device("cpu")}
    one = data_mesh(device="cpu")  # the CPU asked for explicitly: one device
    assert one.devices == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        data_mesh(2, device="cpu")
    with pytest.raises(ValueError):
        DeviceMesh([])


@pytest.mark.parametrize("nd", [1, 2, 4, 8])
@pytest.mark.parametrize("multiple", [1, 128])
def test_shard_index_rows_pads_as_jax(data, nd, multiple):
    """Padding to a multiple of nd · row_multiple, shard s holding global
    rows [s·shard_rows, (s+1)·shard_rows), zeros past N: the JAX
    package's placement, row for row."""
    index = data[0]
    mesh = DeviceMesh(["cpu"] * nd)
    shards, n = shard_index_rows(index, mesh, extra_row_multiple=multiple)
    want, jn = jax_shard_index_rows(index, jax_data_mesh(nd), extra_row_multiple=multiple)
    assert n == jn == N and len(shards) == nd
    assert len({s.shape for s in shards}) == 1
    np.testing.assert_array_equal(torch.cat(shards).numpy(), np.asarray(want))
    copies = replicate(data[1], mesh)
    assert len(copies) == nd and all(c.data_ptr() == copies[0].data_ptr() for c in copies)


@pytest.mark.parametrize("nd", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_matches_jax(data, kind, nd):
    """Every variant at every mesh size against JAX's sharded Pallas route:
    s8s8 at the same nd, bitwise (the query scale, the exact sums, the
    merge's tie order); the other kinds against JAX's 8-shard result
    (its merge is lossless, so nd does not move it: masked s8s8 bitwise,
    the float kinds within fp32 order)."""
    exact = kind in EXACT
    jv, jg = _jax_sharded(kind, nd if kind == "s8s8" else 8, data)
    tv, tg = _port_sharded(kind, nd, data)
    assert tg.max() < N  # padding never surfaces
    np.testing.assert_array_equal(tg, jg)
    if exact:
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, jv, atol=TOL)
    if kind.startswith("masked"):
        row_masks, qmask = data[2], data[3]
        assert (tg[0] == -1).all()  # a query mask of 0 matches nothing
        hit = tg >= 0
        assert ((row_masks[np.where(hit, tg, 0)] & qmask[:, None]) != 0)[hit].all()


@pytest.mark.parametrize("kind", ["f32", "s8s8", "masked bf16", "masked row"])
def test_mesh_size_does_not_move_results(data, kind):
    """The merge is lossless: 1, 2, 4 and 8 shards return the same lists
    (s8s8 bitwise; float kinds within fp32 summation order)."""
    v1, g1 = _port_sharded(kind, 1, data)
    for nd in (2, 4, 8):
        v, g = _port_sharded(kind, nd, data)
        np.testing.assert_array_equal(g, g1)
        np.testing.assert_allclose(v, v1, atol=0 if kind in EXACT else TOL)


@pytest.mark.parametrize("variant", ["s8s8", "row"])
@pytest.mark.parametrize("nd", [2, 8])
def test_sharded_int8_is_the_single_device_scan(data, variant, nd):
    """The sharded int8 route equals the port's single-device scan of the
    whole index given the same s8s8 query scale: the quotient of the
    reference's sharded route, bitwise. Against the single-device
    default (the product with f32(1/127), as the reference's
    single-device jit) the ids are equal and the values differ where the
    two scales differ in their last bit: within 2^-22 relative."""
    index, queries, _, _ = data
    values, scales = quantize_int8(_t(index))
    tv, tg = _port_sharded(variant, nd, data)
    qv, qi = ft.fused_topk_int8(values, scales, _t(queries), K, variant=variant,
                                query_scale="quotient")
    np.testing.assert_array_equal(tg, qi.numpy())
    np.testing.assert_allclose(tv, qv.numpy(), atol=0 if variant == "s8s8" else TOL)
    sv, si = ft.fused_topk_int8(values, scales, _t(queries), K, variant=variant)
    np.testing.assert_array_equal(tg, si.numpy())
    np.testing.assert_allclose(tv, sv.numpy(), rtol=2.0**-22, atol=0)


@pytest.mark.parametrize("dtype,nd,tol,floor", [("f32", 1, 1e-5, 1.0), ("f32", 2, 1e-5, 1.0),
                                                ("f32", 8, 1e-5, 1.0), ("bf16", 8, 5e-3, 0.99),
                                                ("s8s8", 8, 5e-3, 0.9), ("row", 8, 5e-3, 0.9)])
def test_sharded_recall_against_the_oracle(data, dtype, nd, tol, floor):
    """Recall@k against the exact fp32 scan (tests/test_sharded_search.py's
    bounds: f32 exact, bf16 ≥ 0.99, int8 > 0.9)."""
    tv, tg = _port_sharded(dtype, nd, data)
    ov, oi = cosine_topk_numpy(data[0], data[1], K)
    assert recall_at_k(tg, oi, ov, tie_tol=tol, candidate_scores=tv) >= floor
    if dtype == "f32":
        np.testing.assert_allclose(tv, ov, atol=1e-5)


def test_sharded_masked_matches_the_filtered_oracle(data):
    """Category filtering on 8 shards == the exact scan of the eligible rows."""
    index, queries, _, _ = data
    rng = np.random.default_rng(3)
    row_masks = (1 << rng.integers(0, 3, N)).astype(np.int32)
    want = 0b01
    mesh = DeviceMesh(["cpu"] * 8)
    shards, n = shard_index_rows(_t(index), mesh)
    v, g = sharded_topk(shards, _t(queries), K, mesh, n_valid=n,
                        row_masks=shard_index_rows(row_masks, mesh)[0],
                        query_mask=torch.full((Q,), want, dtype=torch.int32))
    eligible = (row_masks & want) != 0
    ov, oi = cosine_topk_numpy(index[eligible], queries, K)
    ids = np.nonzero(eligible)[0]
    assert recall_at_k(g.numpy(), ids[oi], ov, tie_tol=TOL, candidate_scores=v.numpy()) == 1.0
    assert ((row_masks[g.numpy()] & want) != 0).all()


def test_s8s8_and_row_variants_agree(data):
    """The two int8 modes differ only by the query quantization error."""
    v8, _ = _port_sharded("s8s8", 8, data)
    vr, _ = _port_sharded("row", 8, data)
    np.testing.assert_allclose(v8, vr, atol=2e-2)


@pytest.mark.parametrize("kind", ["f32", "masked s8s8"])
def test_large_k_takes_the_plain_scan_per_shard(data, kind):
    """k > 128 scans each shard as the reference's ``_local_scan_xla`` (its
    XLA route, int8 in the row mode): against JAX's sharded XLA route."""
    jv, jg = _jax_sharded(kind, 8, data, k=200, use_pallas=False)
    tv, tg = _port_sharded(kind, 8, data, k=200)
    np.testing.assert_allclose(tv, jv, atol=TOL)
    assert recall_at_k(tg, jg, jv, tie_tol=TOL, candidate_scores=tv) == 1.0
    np.testing.assert_array_equal(tg == -1, jg == -1)


def test_merge_takes_the_lowest_id_among_ties():
    """Equal scores across shards: the earlier shard's (lower) id first;
    within a shard the scan's order is kept; empty slots last."""
    cand_v = torch.tensor([[[0.75, 0.25, float("-inf")]], [[0.75, 0.5, 0.25]]])
    cand_i = torch.tensor([[[3, 4, -1]], [[10, 12, 11]]], dtype=torch.int32)
    v, i = ft.merge_topk(cand_v, cand_i)
    assert i.tolist() == [[3, 10, 12]] and v.tolist() == [[0.75, 0.75, 0.5]]
    v, i = ft.merge_topk(cand_v[:1], cand_i[:1])
    assert i.tolist() == [[3, 4, -1]] and v[0, 2] == float("-inf")


def test_shards_must_lie_on_their_mesh_devices(data):
    mesh = DeviceMesh(["cpu"] * 2)
    shards, n = shard_index_rows(_t(data[0]), mesh)
    with pytest.raises(ValueError, match="shards"):
        sharded_topk(shards[:1], _t(data[1]), K, mesh)
    with pytest.raises(ValueError, match="rows"):
        sharded_topk([shards[0], shards[1][:-1]], _t(data[1]), K, mesh)
    with pytest.raises(ValueError, match="n_valid"):
        sharded_topk(shards, _t(data[1]), K, mesh, n_valid=10**6)


def test_engine_mesh_int8_with_categories():
    """SearchEngine on a mesh-sharded int8 index with a category filter
    equals the single-device engine bitwise and JAX's engine (its Pallas
    s8s8 route) in rows and scores."""
    rng = np.random.default_rng(6)
    embs = rng.standard_normal((96, 64)).astype(np.float32)
    cats = ["cs.LG" if i % 2 else "cs.AI" for i in range(96)]
    q = embs[:8] / np.linalg.norm(embs[:8], axis=1, keepdims=True)
    meshed_idx = build_index(embs, categories=cats, dtype="int8")
    meshed_idx.to_device(mesh=DeviceMesh(["cpu"] * 8))
    assert meshed_idx._device_values is None and len(meshed_idx._shard_values) == 8
    meshed = SearchEngine(meshed_idx)
    single = SearchEngine(build_index(embs, categories=cats, dtype="int8"), device="cpu")
    jax_eng = JaxSearchEngine(jax_build_index(embs, categories=cats, dtype="int8"),
                              use_pallas=True)
    v1, r1 = meshed.search_embeddings(q, k=5, categories=["cs.LG"])
    v2, r2 = single.search_embeddings(q, k=5, categories=["cs.LG"])
    jv, jr = jax_eng.search_embeddings(q, k=5, categories=["cs.LG"])
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(r1, np.asarray(jr))
    np.testing.assert_array_equal(v1, np.asarray(jv))
    assert (np.asarray(r1) % 2 == 1).all()
    with pytest.raises(RuntimeError, match="sharded"):  # no stale single-device scan
        meshed._single_chip(torch.from_numpy(q), 5, None)

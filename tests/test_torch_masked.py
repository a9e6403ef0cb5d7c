"""Category-filtered scans (K4) and the int8 "row" scan (K3) on the CPU
against the JAX reference, and the engine's category route against the
JAX engine.

The JAX kernels run in Pallas interpret mode, as tests/test_pallas_topk.py
runs them; the port's wrappers take their plain versions for CPU tensors.
Inputs are made with numpy seeds and handed to both packages. Row masks
use all 32 category bits, so bit 31 (the int32 sign bit) is exercised.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arxiv_rag_tpu.index.store import build_index as jax_build_index
from arxiv_rag_tpu.ops.pallas_topk import fused_topk_int8 as jax_fused_topk_int8
from arxiv_rag_tpu.ops.pallas_topk import fused_topk_int8_masked as jax_int8_masked
from arxiv_rag_tpu.ops.pallas_topk import fused_topk_masked as jax_fused_topk_masked
from arxiv_rag_tpu.ops.quant import quantize_int8 as jax_quantize_int8
from arxiv_rag_tpu.search import SearchEngine as JaxSearchEngine

from arxiv_rag_tpu_torch.index import build_index
from arxiv_rag_tpu_torch.ops import fused_topk as ft
from arxiv_rag_tpu_torch.ops.quant import quantize_int8
from arxiv_rag_tpu_torch.ops.topk import recall_at_k
from arxiv_rag_tpu_torch.search import SearchEngine

N, D, Q, K = 3000, 128, 32, 10
BLOCK = 512
TOL = 1e-5  # fp32 sums over D terms in another order than the Pallas kernel
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CATS = [f"cs.{i:02d}" for i in range(32)]


def _normalize(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(13)
    index = _normalize(rng.standard_normal((N, D), dtype=np.float32))
    queries = _normalize(rng.standard_normal((Q, D), dtype=np.float32))
    codes = rng.integers(0, 32, N)
    row_masks = (np.uint32(1) << codes.astype(np.uint32)).astype(np.uint32)
    qmask = rng.integers(1, 2**32, Q, dtype=np.uint64).astype(np.uint32)
    qmask[0] = 0  # matches nothing
    qmask[1] = np.uint32(1 << 31)  # category 31 only: the sign bit
    qmask[2] = np.uint32(0xFFFFFFFF)
    qmask[3] = np.uint32(0b111)
    return index, queries, codes, row_masks.view(np.int32), qmask.view(np.int32)


def _jax_masks(rm, qm):
    return jnp.asarray(rm), jnp.asarray(qm)


def _check_close(tv, ti, jv, ji):
    tv, ti, jv, ji = (np.asarray(a) for a in (tv, ti, jv, ji))
    np.testing.assert_allclose(tv, jv, atol=TOL)
    assert recall_at_k(ti, ji, jv, tie_tol=TOL, candidate_scores=tv) == 1.0
    np.testing.assert_array_equal(ti == -1, ji == -1)  # the same empty slots


@pytest.mark.parametrize("n", [3000, 2900])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_topk_masked_matches_jax(data, n, dtype):
    """K4 f32/bf16: values within 1e-5, tie-tolerant recall 1.0, the
    mask-0 query all (-inf, -1), rows past n_valid never returned."""
    index, queries, _, rm, qm = data
    jv, ji = jax_fused_topk_masked(jnp.asarray(index, dtype), *_jax_masks(rm, qm),
                                   jnp.asarray(queries), K, n_valid=n, block_rows=BLOCK,
                                   interpret=True)
    tv, ti = ft.fused_topk_masked(_t(index, TORCH_DTYPE[dtype]), _t(rm), _t(qm),
                                  _t(queries), K, n_valid=n)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32 and ti.shape == (Q, K)
    assert ti.max() < n
    assert (ti[0] == -1).all() and torch.isinf(tv[0]).all()
    _check_close(tv, ti, jv, ji)


@pytest.mark.parametrize("n", [3000, 2900])
def test_fused_topk_int8_masked_s8s8_bitwise_jax(data, n):
    """K4 s8s8 (the reference's default): exact integer products and the
    same fp32 steps, so values and ids are bitwise equal."""
    index, queries, _, rm, qm = data
    jq, js = jax_quantize_int8(index)
    jv, ji = jax_int8_masked(jq, js, *_jax_masks(rm, qm), jnp.asarray(queries), K,
                             n_valid=n, block_rows=BLOCK, interpret=True)
    vals, scales = quantize_int8(_t(index))
    tv, ti = ft.fused_topk_int8_masked(vals, scales, _t(rm), _t(qm), _t(queries), K,
                                       n_valid=n)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("masked", [False, True])
def test_fused_topk_int8_row_matches_jax(data, masked):
    """K3 (variant "row"): bf16 queries, fp32 sums in another order than
    the Pallas kernel, one product with the row scale: within 1e-5,
    tie-tolerant recall 1.0, alone and under the category filter."""
    index, queries, _, rm, qm = data
    jq, js = jax_quantize_int8(index)
    vals, scales = quantize_int8(_t(index))
    if masked:
        jv, ji = jax_int8_masked(jq, js, *_jax_masks(rm, qm), jnp.asarray(queries), K,
                                 n_valid=2900, block_rows=BLOCK, interpret=True,
                                 _variant="row")
        tv, ti = ft.fused_topk_int8_masked(vals, scales, _t(rm), _t(qm), _t(queries), K,
                                           n_valid=2900, variant="row")
    else:
        jv, ji = jax_fused_topk_int8(jq, js, jnp.asarray(queries), K, n_valid=2900,
                                     block_rows=BLOCK, interpret=True, _variant="row")
        tv, ti = ft.fused_topk_int8(vals, scales, _t(queries), K, n_valid=2900,
                                    variant="row")
    assert ti.max() < 2900
    _check_close(tv, ti, jv, ji)


def test_masked_plain_equals_filtered_rows(data):
    """The filter is exact: a masked scan equals the unmasked scan of
    only the eligible rows, ids mapped back."""
    index, queries, codes, rm, _ = data
    keep = np.flatnonzero(codes == 31)
    qm = np.full((Q,), np.uint32(1 << 31)).view(np.int32)
    tv, ti = ft.fused_topk_masked(_t(index), _t(rm), _t(qm), _t(queries), K)
    sv, si = ft.fused_topk(_t(index[keep]), _t(queries), K)
    np.testing.assert_array_equal(ti.numpy(), keep[si.numpy()])
    np.testing.assert_array_equal(tv.numpy(), sv.numpy())


def test_int8_variant_is_checked(data):
    index, queries, _, _, _ = data
    vals, scales = quantize_int8(_t(index[:100]))
    with pytest.raises(ValueError, match="variant"):
        ft.fused_topk_int8(vals, scales, _t(queries), K, variant="nodequant")


# -- the store and the engine's category route ------------------------------


@pytest.fixture(scope="module")
def indexes(data):
    index, _, codes, _, _ = data
    cats = np.array(CATS)[codes]
    return {dtype: (jax_build_index(index, categories=cats, category_names=CATS, dtype=dtype),
                    build_index(index, categories=cats, category_names=CATS, dtype=dtype))
            for dtype in ("float32", "bfloat16", "int8")}


def test_category_mask_and_device_masks_match_jax(indexes):
    jidx, idx = indexes["int8"]
    for wanted in (None, [], ["cs.00"], ["cs.31"], ["cs.03", "cs.31", "cs.07"], CATS):
        assert idx.category_mask(wanted) == jidx.category_mask(wanted)
        assert type(idx.category_mask(wanted)) is np.uint32
    with pytest.raises(KeyError, match="unknown category"):
        idx.category_mask(["cs.XX"])
    idx.to_device("cpu", row_multiple=4096)
    jidx.to_device()
    assert idx._device_masks.dtype == torch.int32 and idx._device_masks.shape == (4096,)
    np.testing.assert_array_equal(idx._device_masks.numpy(), np.asarray(jidx._device_masks))
    assert (idx._device_masks.numpy()[N:] == 0).all()


@pytest.mark.parametrize("k", [K, 150])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_engine_category_route_matches_jax(data, indexes, dtype, k):
    """``search_embeddings(categories=...)`` through the fused masked
    scans (k ≤ 128) and the plain masked scans (k > 128): int8 k ≤ 128
    bitwise (s8s8), the rest within 1e-5 with tie-tolerant recall 1.0."""
    _, queries, _, _, _ = data
    jidx, idx = indexes[dtype]
    jeng = JaxSearchEngine(jidx, use_pallas=True)
    eng = SearchEngine(idx, device="cpu")
    q = queries[:13]  # a ragged window: pads to the bucket of 32
    for cats in (["cs.31"], ["cs.01", "cs.02", "cs.05"]):
        jv, jr = (np.asarray(a) for a in jeng.search_embeddings(q, k, categories=cats))
        tv, tr = eng.search_embeddings(q, k, categories=cats)
        assert tv.shape == (13, k)
        if dtype == "int8" and k <= 128:
            np.testing.assert_array_equal(tv, jv)
            np.testing.assert_array_equal(tr, jr)
            continue
        np.testing.assert_allclose(tv, jv, atol=TOL)
        finite = np.isfinite(jv)  # past the eligible rows both sides are -inf
        assert (np.isfinite(tv) == finite).all()
        assert recall_at_k(np.where(finite, tr, -1), np.where(finite, jr, -1), jv,
                           tie_tol=TOL, candidate_scores=tv) == 1.0


class _StubEmbedder:
    """Fixed query vectors in place of the encoder."""

    def __init__(self, vectors):
        self.vectors = vectors

    def encode_window_device(self, texts):
        return None

    def encode_texts(self, texts):
        return self.vectors[: len(texts)]


def test_no_categories_match_nothing(data, indexes):
    """``categories=[]`` matches no row: empty result lists, as the JAX
    engine answers."""
    _, queries, _, _, _ = data
    for dtype in ("bfloat16", "int8"):
        jidx, idx = indexes[dtype]
        eng = SearchEngine(idx, embedder=_StubEmbedder(queries), device="cpu")
        assert eng.search(["a", "b", "c"], k=K, categories=[]) == [[], [], []]
        jv, _ = JaxSearchEngine(jidx, use_pallas=True).search_embeddings(
            queries[:3], K, categories=[])
        assert np.isneginf(np.asarray(jv)).all()
        hits = eng.search(["a", "b"], k=K, categories=["cs.04"])
        assert all(len(h) == K for h in hits)
        codes = data[2]
        assert all(codes[h.row] == 4 for hits_q in hits for h in hits_q)


def test_filter_needs_row_masks(data):
    index, queries, _, _, _ = data
    eng = SearchEngine(build_index(index[:200], dtype="float32"), device="cpu")
    with pytest.raises(KeyError, match="unknown category"):
        eng.search_embeddings(queries[:2], K, categories=["cs.00"])
    with pytest.raises(ValueError, match="without categories"):
        eng.search_embeddings(queries[:2], K, categories=[])

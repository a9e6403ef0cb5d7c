"""The port's scan ops on the CPU against the JAX reference.

The JAX fused kernels run in Pallas interpret mode, as
tests/test_pallas_topk.py runs them; the port's wrappers take their
plain versions for CPU tensors. Inputs are made with numpy seeds and
handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arxiv_rag_tpu.ops.pallas_topk import fused_topk as jax_fused_topk
from arxiv_rag_tpu.ops.pallas_topk import fused_topk_int8 as jax_fused_topk_int8
from arxiv_rag_tpu.ops.quant import int8_search as jax_int8_search
from arxiv_rag_tpu.ops.quant import quantize_int8 as jax_quantize_int8
from arxiv_rag_tpu.ops.topk import flat_search as jax_flat_search

from arxiv_rag_tpu_torch.ops import fused_topk as ft
from arxiv_rag_tpu_torch.ops.quant import int8_search, quantize_int8
from arxiv_rag_tpu_torch.ops.topk import flat_search, recall_at_k

N, D, Q, K = 3000, 128, 32, 10
BLOCK = 512
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normalize(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    index = _normalize(rng.standard_normal((N, D), dtype=np.float32))
    queries = _normalize(rng.standard_normal((Q, D), dtype=np.float32))
    return index, queries


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


@pytest.mark.parametrize("n", [3000, 2900])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_topk_matches_jax(data, n, dtype):
    """Values within 1e-5 (fp32 sums in another order) and tie-tolerant
    recall 1.0 against the Pallas kernel; padding rows never surface."""
    index, queries = data
    jv, ji = jax_fused_topk(jnp.asarray(index[:n], dtype), jnp.asarray(queries), K,
                            block_rows=BLOCK, interpret=True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = ft.fused_topk(_t(index[:n], TORCH_DTYPE[dtype]), _t(queries), K)
    tv, ti = tv.numpy(), ti.numpy()
    assert tv.dtype == np.float32 and ti.dtype == np.int32 and ti.shape == (Q, K)
    assert ti.max() < n
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    assert recall_at_k(ti, ji, jv, tie_tol=1e-5, candidate_scores=tv) == 1.0


def test_fused_topk_n_valid_masks_rows(data):
    """n_valid hides the rows past it exactly as slicing them off does."""
    index, queries = data
    sv, si = ft.fused_topk(_t(index), _t(queries), K, n_valid=2900)
    cv, ci = ft.fused_topk(_t(index[:2900]), _t(queries), K)
    assert torch.equal(si, ci) and torch.equal(sv, cv)


def test_fused_topk_ties_lowest_id_wins(data):
    """Duplicated rows give exact ties across blocks: the lowest global id
    wins, as in lax.top_k and the Pallas kernel."""
    _, queries = data
    rng = np.random.default_rng(5)
    base = _normalize(rng.standard_normal((40, D), dtype=np.float32))
    index = np.tile(base, (40, 1))
    _, li = jax.lax.top_k(jnp.asarray(queries @ index.T), K)
    _, ji = jax_fused_topk(jnp.asarray(index), jnp.asarray(queries), K,
                           block_rows=BLOCK, interpret=True)
    _, ti = ft.fused_topk(_t(index), _t(queries), K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(li))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_k_above_rows_pads_minus_inf_minus_one(data, kind):
    index, queries = data
    small = index[:5]
    if kind == "int8":
        vals, scales = quantize_int8(_t(small))
        tv, ti = ft.fused_topk_int8(vals, scales, _t(queries), K)
        jq, js = jax_quantize_int8(small)
        jv, ji = jax_fused_topk_int8(jq, js, jnp.asarray(queries), K, interpret=True)
    else:
        tv, ti = ft.fused_topk(_t(small), _t(queries), K)
        jv, ji = jax_fused_topk(jnp.asarray(small), jnp.asarray(queries), K, interpret=True)
    assert (ti[:, 5:] == -1).all() and torch.isinf(tv[:, 5:]).all()
    assert (ti[:, :5] >= 0).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n", [3000, 2900])
def test_fused_topk_int8_s8s8_bitwise_jax(data, n):
    """s8s8: exact integer products, the same fp32 scaling steps — values
    and ids bitwise equal to the Pallas kernel."""
    index, queries = data
    jq, js = jax_quantize_int8(index[:n])
    jv, ji = jax_fused_topk_int8(jq, js, jnp.asarray(queries), K,
                                 block_rows=BLOCK, interpret=True)
    vals, scales = quantize_int8(_t(index[:n]))
    tv, ti = ft.fused_topk_int8(vals, scales, _t(queries), K)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_fused_topk_int8_n_valid_masks_rows(data):
    index, queries = data
    vals, scales = quantize_int8(_t(index))
    sv, si = ft.fused_topk_int8(vals, scales, _t(queries), K, n_valid=2900)
    cv, ci = ft.fused_topk_int8(vals[:2900], scales[:2900], _t(queries), K)
    assert torch.equal(si, ci) and torch.equal(sv, cv)


def test_query_quantization_matches_pallas_wrapper():
    """s8s8 query quantization as the reference's jit computes it
    (pallas_topk.py:904-908), where ``/ 127.0`` compiles to a product."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((500, D)).astype(np.float32)
    q[0] = 0.0  # an all-zero row takes the floor

    @jax.jit
    def reference(qf):
        qs = jnp.maximum(jnp.max(jnp.abs(qf), axis=1, keepdims=True), 1e-8) / 127.0
        return jnp.clip(jnp.round(qf / qs), -127, 127).astype(jnp.int8), qs

    q8, qs = ft.quantize_queries(_t(q))
    want_q, want_s = reference(jnp.asarray(q))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(want_s)[:, 0])


def test_quantize_int8_bitwise_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((257, 96)).astype(np.float32)
    x[3] = 0.0  # absmax floor
    x[4, :5] = [0.5, -0.5, 1.5, 2.5, -2.5]  # exact halves round to even
    jq, js = jax_quantize_int8(x)
    tq, ts = quantize_int8(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_flat_search_large_k_matches_jax(data):
    """k > 128 goes to the unfused scan (the fused kernels cap k)."""
    index, queries = data
    jv, ji = jax_flat_search(jnp.asarray(index), jnp.asarray(queries), 200)
    tv, ti = flat_search(_t(index), _t(queries), 200)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    assert recall_at_k(ti.numpy(), np.asarray(ji), np.asarray(jv), tie_tol=1e-5,
                       candidate_scores=tv.numpy()) == 1.0
    with pytest.raises(ValueError, match="1..128"):
        ft.fused_topk(_t(index), _t(queries), 200)


def test_int8_search_matches_jax(data):
    index, queries = data
    jq, js = jax_quantize_int8(index)
    jv, ji = jax_int8_search(jq, js, jnp.asarray(queries), 150)
    vals, scales = quantize_int8(_t(index))
    tv, ti = int8_search(vals, scales, _t(queries), 150)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    assert recall_at_k(ti.numpy(), np.asarray(ji), np.asarray(jv), tie_tol=1e-5,
                       candidate_scores=tv.numpy()) == 1.0


def test_wrappers_refuse_other_devices(data):
    index, queries = data
    meta = torch.empty((N, D), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ft.fused_topk(meta, _t(queries), K)

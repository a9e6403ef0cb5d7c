"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no card and run on one with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``. chip_smoke.py
checks the same kernels at the serving shapes."""

import pytest
import torch

from arxiv_rag_tpu_torch.ops import fused_topk as ft
from arxiv_rag_tpu_torch.ops.quant import quantize_int8
from arxiv_rag_tpu_torch.ops.topk import recall_at_k

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _unit(n, d, gen):
    x = torch.randn(n, d, generator=gen, device="cuda")
    return x / x.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("nq,k", [(1, 1), (17, 10), (100, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain(gen, nq, k, dtype):
    x = _unit(70_001, 768, gen).to(dtype)
    q = _unit(nq, 768, gen)
    v, i = ft.fused_topk(x, q, k, n_valid=69_964)
    pv, pi = ft.fused_topk_plain(x, q, k, n_valid=69_964)
    v, i, pv, pi = (t.cpu().numpy() for t in (v, i, pv, pi))
    assert i.max() < 69_964
    assert abs(v - pv).max() <= 1e-4  # fp32 sums over 768 terms in another order
    assert recall_at_k(i, pi, pv, tie_tol=1e-4, candidate_scores=v) == 1.0


@pytest.mark.parametrize("nq,k", [(1, 1), (17, 10), (100, 128)])
def test_k2_bitwise_plain(gen, nq, k):
    x8, s8 = quantize_int8(_unit(70_001, 768, gen))
    q = _unit(nq, 768, gen)
    v, i = ft.fused_topk_int8(x8, s8, q, k, n_valid=69_964)
    pv, pi = ft.fused_topk_int8_plain(x8, s8, q, k, n_valid=69_964)
    assert torch.equal(v, pv) and torch.equal(i, pi)


def test_ties_and_short_results(gen):
    base = _unit(40, 128, gen)
    x = base.repeat(40, 1)
    q = _unit(32, 128, gen)
    _, i = ft.fused_topk(x, q, 10)
    _, pi = ft.fused_topk_plain(x, q, 10)
    assert torch.equal(i, pi)
    v, i = ft.fused_topk(x[:5], q, 10)
    assert (i[:, 5:] == -1).all() and torch.isinf(v[:, 5:]).all()


@pytest.mark.parametrize("batched", [False, True])
def test_bf16_products_keep_fp32(gen, batched):
    """The encoder's bf16 products on the card come out in fp32, unrounded:
    within fp32 summation order (1e-3 at |sum| ~ 28) of the products summed
    in fp32, where a bf16 output is off by up to half a bf16 step (~0.06)."""
    from arxiv_rag_tpu_torch.models.mpnet import _matmul_f32

    shape_a, shape_b = ((8, 12, 128, 64), (8, 12, 64, 128)) if batched else \
        ((1024, 768), (768, 3072))
    a = torch.randn(shape_a, generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn(shape_b, generator=gen, device="cuda").to(torch.bfloat16)
    out = _matmul_f32(a, b)
    want = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    assert out.dtype == torch.float32
    assert (out - want).abs().max().item() <= 1e-3
    assert (torch.matmul(a, b).to(torch.float32) - want).abs().max().item() > 1e-3


def test_launches_are_counted(gen):
    x = _unit(4096, 128, gen)
    ft.reset_launches()
    ft.fused_topk(x, x[:3], 5)
    ft.fused_topk_plain(x, x[:3], 5)
    assert ft.LAUNCHES["fused_topk"] == 1

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


# -- slice 2: masked (K4), int8 row (K3), block tables (K5), device plan (K6) --


def _masks(n, nq, gen):
    codes = torch.randint(0, 32, (n,), generator=gen, device="cuda")
    rm = torch.bitwise_left_shift(torch.ones_like(codes), codes).to(torch.int32)  # bit 31 wraps
    qm = torch.full((nq,), 0b111, dtype=torch.int32, device="cuda")
    qm[0] = 0
    qm[1] = -2**31  # category 31: the sign bit
    return rm.contiguous(), qm


@pytest.mark.parametrize("nq,k", [(3, 1), (17, 10), (100, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_float_matches_plain(gen, nq, k, dtype):
    x = _unit(70_001, 768, gen).to(dtype)
    q = _unit(nq, 768, gen)
    rm, qm = _masks(70_001, nq, gen)
    v, i = ft.fused_topk_masked(x, rm, qm, q, k, n_valid=69_964)
    pv, pi = ft.fused_topk_masked_plain(x, rm, qm, q, k, n_valid=69_964)
    assert (i[0] == -1).all() and torch.isinf(v[0]).all()
    v, i, pv, pi = (t.cpu().numpy() for t in (v, i, pv, pi))
    real = pi >= 0
    assert i.max() < 69_964 and ((i >= 0) == real).all()
    assert abs(v[real] - pv[real]).max() <= 1e-4  # fp32 sums in another order
    assert recall_at_k(i, pi, pv, tie_tol=1e-4, candidate_scores=v) == 1.0


@pytest.mark.parametrize("nq,k", [(3, 1), (17, 10), (100, 128)])
def test_k4_s8s8_bitwise_plain(gen, nq, k):
    x8, s8 = quantize_int8(_unit(70_001, 768, gen))
    q = _unit(nq, 768, gen)
    rm, qm = _masks(70_001, nq, gen)
    v, i = ft.fused_topk_int8_masked(x8, s8, rm, qm, q, k, n_valid=69_964)
    pv, pi = ft.fused_topk_int8_masked_plain(x8, s8, rm, qm, q, k, n_valid=69_964)
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nq,k", [(3, 1), (17, 10), (100, 128)])
def test_k3_row_matches_plain(gen, nq, k, masked):
    x8, s8 = quantize_int8(_unit(70_001, 768, gen))
    q = _unit(nq, 768, gen)
    if masked:
        rm, qm = _masks(70_001, nq, gen)
        v, i = ft.fused_topk_int8_masked(x8, s8, rm, qm, q, k, n_valid=69_964, variant="row")
        pv, pi = ft.fused_topk_int8_masked_plain(x8, s8, rm, qm, q, k, n_valid=69_964,
                                                 variant="row")
    else:
        v, i = ft.fused_topk_int8(x8, s8, q, k, n_valid=69_964, variant="row")
        pv, pi = ft.fused_topk_int8_plain(x8, s8, q, k, n_valid=69_964, variant="row")
    v, i, pv, pi = (t.cpu().numpy() for t in (v, i, pv, pi))
    real = pi >= 0
    assert ((i >= 0) == real).all() and abs(v[real] - pv[real]).max() <= 1e-4
    assert recall_at_k(i, pi, pv, tie_tol=1e-4, candidate_scores=v) == 1.0


def _ivf_layout(gen, dtype, block_rows, n=20_000):
    from arxiv_rag_tpu_torch.ops.ivf import pad_index_for_ivf

    x = _unit(n, 768, gen)
    scales = None
    if dtype == torch.int8:
        x, scales = quantize_int8(x)
    else:
        x = x.to(dtype)
    rm, _ = _masks(n, 2, gen)
    return pad_index_for_ivf(x, block_rows, scales=scales, row_masks=rm), n


@pytest.mark.parametrize("block_rows", [1024, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_k5_matches_plain(gen, dtype, block_rows):
    from arxiv_rag_tpu_torch.ops import ivf as oivf

    (x, s, rm, dead), n = _ivf_layout(gen, dtype, block_rows)
    q = _unit(21, 768, gen)  # a ragged last tile
    tiles = 3
    table = torch.full((tiles, 12), dead, dtype=torch.int32)
    for t in range(tiles):
        real = torch.randperm(dead, generator=torch.Generator().manual_seed(t))[: 4 + 3 * t]
        table[t, : len(real)] = torch.sort(real).values
    qm = torch.full((21,), 0b111, dtype=torch.int32, device="cuda")
    for kw in ({}, {"row_masks": rm, "query_mask": qm}):
        if dtype == torch.int8:
            kw["scales"] = s
        v, i = oivf._table_scan(x, table, q, 10, n_valid=n, block_rows=block_rows,
                                q_block=8, **kw)
        pv, pi = oivf.ivf_topk_plain(x, table, q, 10, n_valid=n, block_rows=block_rows,
                                     q_block=8, **kw)
        v, i, pv, pi = (t.cpu().numpy() for t in (v, i, pv, pi))
        real = pi >= 0
        assert ((i >= 0) == real).all() and abs(v[real] - pv[real]).max() <= 1e-4
        assert recall_at_k(i, pi, pv, tie_tol=1e-4, candidate_scores=v) == 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_k6_bitwise_k5_without_host_sync(gen, dtype):
    """The device plan covers the host plan's blocks: K6 equals K5 bit for
    bit, and its dispatch never waits for the device."""
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex
    from arxiv_rag_tpu_torch.index.store import build_index

    x = _unit(30_000, 768, gen)
    dense = build_index(x, dtype="int8" if dtype == torch.int8 else "bfloat16").to_device()
    ivf = IVFIndex.build(dense, 64, block_rows=1024, iters=3)
    q = _unit(32, 768, gen)
    hv, hl = ivf._search_table(q, ivf.plan_blocks(ivf.probe(q, 4), 8), 10, q_block=8)
    torch.cuda.synchronize()
    ft.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dv, dl = ivf._search_device(q, 10, nprobe=4, q_block=8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ft.LAUNCHES["ivf_topk_device"] == 1 and ft.LAUNCHES["ivf_topk"] == 0
    assert torch.equal(dv, hv) and torch.equal(dl, hl)
    assert ft.LAUNCHES["fused_topk_int8_row"] == (1 if dtype == torch.int8 else 0)

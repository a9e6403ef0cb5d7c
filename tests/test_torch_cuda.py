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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launches_are_counted(gen, dtype):
    x = _unit(4096, 128, gen).to(dtype)
    ft.reset_launches()
    ft.fused_topk(x, x[:3].float(), 5)
    ft.fused_topk_plain(x, x[:3].float(), 5)
    assert ft.LAUNCHES["fused_topk"] == 1


# -- the tensor-core scan: every flat scan (K1 f32 and bf16, K2, K3, K4) -------


def _check_like_plain(v, i, pv, pi, n_valid):
    """Within 1e-4 (fp32 sums in another order), tie-tolerant recall 1.0,
    the empty slots (-inf, -1) in the same places, no id past n_valid."""
    v, i, pv, pi = (t.cpu().numpy() for t in (v, i, pv, pi))
    real = pi >= 0
    assert ((i >= 0) == real).all() and (v[~real] == -float("inf")).all()
    assert i.max(initial=-1) < n_valid
    if real.any():
        assert abs(v[real] - pv[real]).max() <= 1e-4
    assert recall_at_k(i, pi, pv, tie_tol=1e-4, candidate_scores=v) == 1.0


# (Q, k, D, rows, n_valid, masked): the query tile's edges (64 per block),
# the list capacity's (16 per list, 128), D at one, two and twelve slices;
# n_valid off the 128-row tile, below one tile, and 0. D = 896 is the
# largest whose bf16 queries stay resident in shared memory; from 960 on
# they stream through the ring, as f32 and row queries always do (1408:
# the largest D the CUDA-core scan took for bf16)
_TC_CASES = [
    *[(nq, 10, 768, 20_000, 19_937, False) for nq in (1, 63, 64, 65, 129, 512)],
    *[(65, k, 128, 20_000, 19_937, False) for k in (1, 16, 17, 128)],
    (64, 10, 64, 20_000, 19_937, False),
    (129, 10, 128, 20_000, 19_937, True),
    (512, 10, 768, 20_000, 19_937, True),
    (63, 128, 768, 20_000, 19_937, True),
    (65, 17, 64, 20_000, 19_937, True),
    (70, 10, 128, 300, 100, False),
    (70, 128, 128, 300, 100, True),
    (3, 5, 128, 300, 0, False),
    (65, 10, 896, 5_000, 4_937, False),
    (65, 128, 896, 5_000, 4_937, True),
    (1, 10, 960, 5_000, 4_937, False),
    (129, 10, 1024, 5_000, 4_937, True),
    (65, 128, 1024, 5_000, 4_937, False),
    (64, 17, 1408, 5_000, 4_937, True),
    (70, 16, 2048, 5_000, 4_937, False),
]
_KINDS = ("bf16", "f32", "s8s8", "row")
# f32, s8s8 and row beyond the cases above, unmasked and (past the
# resident limits) masked: the largest D the CUDA-core scans took (f32
# 1408), s8s8 past its resident limit (D = 1280; 1536 for k > 16) and
# both int8 kinds up to the CUDA-core scan's largest (5760)
_TC_MORE = [
    *[(nq, 10, 768, 20_000, 19_937, False) for nq in (1, 63, 64, 65, 129, 512)],
    *[(*case, masked) for case in ((64, 16, 1408, 5_000, 4_937), (129, 128, 1408, 5_000, 4_937),
                                   (512, 10, 2048, 3_000, 2_937)) for masked in (False, True)],
]
_S8_MORE = [(*case, masked) for case in ((65, 10, 4096, 3_000, 2_937),
                                         (64, 128, 4096, 3_000, 2_937),
                                         (63, 17, 5760, 2_000, 1_937))
            for masked in (False, True)]
_TC_PARAMS = [
    *[(kind, *case) for case in _TC_CASES for kind in _KINDS],
    *[(kind, *case) for case in _TC_MORE for kind in ("f32", "s8s8", "row")],
    *[(kind, *case) for case in _S8_MORE for kind in ("s8s8", "row")],
]
_INT8 = ("s8s8", "row")


def _tc_index(kind, x, n_valid):
    """Unit rows as an index of ``kind`` (s8s8, row: quantized, the rows
    past n_valid with a large row scale)."""
    if kind not in _INT8:
        return x.to(torch.float32 if kind == "f32" else torch.bfloat16), None
    x8, s = quantize_int8(x)
    s[n_valid:] = 1e3
    return x8, s


def _tc_scan(kind, x, s, q, k, n_valid=None, masks=None):
    """(kernel, plain) results of a flat scan of ``kind``, under the
    category filter ``masks`` = (row masks, query masks) when given."""
    if kind in _INT8 and masks is None:
        return (ft.fused_topk_int8(x, s, q, k, n_valid=n_valid, variant=kind),
                ft.fused_topk_int8_plain(x, s, q, k, n_valid=n_valid, variant=kind))
    if kind in _INT8:
        return (ft.fused_topk_int8_masked(x, s, *masks, q, k, n_valid=n_valid, variant=kind),
                ft.fused_topk_int8_masked_plain(x, s, *masks, q, k, n_valid=n_valid,
                                                variant=kind))
    if masks is None:
        return (ft.fused_topk(x, q, k, n_valid=n_valid),
                ft.fused_topk_plain(x, q, k, n_valid=n_valid))
    return (ft.fused_topk_masked(x, *masks, q, k, n_valid=n_valid),
            ft.fused_topk_masked_plain(x, *masks, q, k, n_valid=n_valid))


def _check_kind(kind, got, want, n_valid):
    """s8s8 bitwise; the float sums (f32, bf16, row) as ``_check_like_plain``."""
    (v, i), (pv, pi) = got, want
    if kind == "s8s8":
        assert torch.equal(v, pv) and torch.equal(i, pi)
        assert i.max().item() < n_valid
    else:
        _check_like_plain(v, i, pv, pi, n_valid)


@pytest.mark.parametrize("kind,nq,k,d,n,n_valid,masked", _TC_PARAMS)
def test_tc_scan_matches_plain(gen, kind, nq, k, d, n, n_valid, masked):
    """The rows past n_valid are copies of a query: read, they would win."""
    x = _unit(n, d, gen)
    q = _unit(nq, d, gen)
    x[n_valid:] = q[0]
    x, s = _tc_index(kind, x, n_valid)
    ft.reset_launches()
    (v, i), (pv, pi) = _tc_scan(kind, x, s, q, k, n_valid, _masks(n, nq, gen) if masked else None)
    if masked:
        assert (i[0] == -1).all() and torch.isinf(v[0]).all()  # the mask-0 query
    counter = ("fused_topk_masked" if masked else
               {"s8s8": "fused_topk_int8", "row": "fused_topk_int8_row"}.get(kind, "fused_topk"))
    assert ft.LAUNCHES[counter] == 1
    assert ft.LAUNCHES["fused_topk_int8_row"] == (kind == "row")
    assert v.shape == (nq, k) and v.dtype == torch.float32 and i.dtype == torch.int32
    _check_kind(kind, (v, i), (pv, pi), n_valid)


@pytest.mark.parametrize("kind,masked", [("bf16", False), ("bf16", True), ("f32", False),
                                         ("f32", True), ("s8s8", False), ("s8s8", True),
                                         ("row", False), ("row", True)])
@pytest.mark.parametrize("k", [10, 128])
def test_tc_ties_ids_bitwise_plain(gen, k, kind, masked):
    """Duplicated rows tie exactly across tiles, splits and lists: the
    lowest ids win, as in the plain version, id for id. Values are small
    multiples of 1/16, so every product and sum is exact in any order (in
    fp32, bf16, 3xTF32 and the int8 kinds): scores tie exactly or differ
    clearly, copies always tie, and so do many different rows. (Random
    unit rows put two different rows within an ulp of each other now and
    then, which two summation orders may rank either way.)"""
    base = torch.randint(-8, 9, (40, 128), generator=gen, device="cuda") / 16
    x, s = _tc_index(kind, base.repeat(40, 1), 1600)
    q = torch.randint(-8, 9, (70, 128), generator=gen, device="cuda") / 16
    masks = _masks(x.shape[0], 70, gen) if masked else None
    (v, i), (pv, pi) = _tc_scan(kind, x, s, q, k, masks=masks)
    assert torch.equal(i, pi)
    _check_kind(kind, (v, i), (pv, pi), x.shape[0])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", _KINDS)
def test_flat_scans_launch_the_tensor_core_kernel(gen, kind, masked):
    """Every flat scan, of every kind, masked or not, runs tc_scan_kernel
    (and the merge), never the block-table kernel."""
    from torch.profiler import ProfilerActivity, profile

    x, s = _tc_index(kind, _unit(20_000, 768, gen), 20_000)
    q = _unit(65, 768, gen)
    masks = _masks(20_000, 65, gen) if masked else None
    _tc_scan(kind, x, s, q, 10, masks=masks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _tc_scan(kind, x, s, q, 10, masks=masks)[0][0].cpu()
    names = [e.key for e in prof.key_averages()]
    assert any("tc_scan_kernel" in n for n in names), names
    assert not any("tc_table_kernel" in n for n in names), names


def test_tc_s8s8_zero_query_and_scales_from_1e8_to_1(gen):
    """An all-zero query (the scale floor: every score 0, ties by id) and
    row scales spanning 1e-8 to 1, bitwise the plain version."""
    x8, _ = quantize_int8(_unit(30_000, 768, gen))
    s = 10.0 ** -(8 * torch.rand(30_000, generator=gen, device="cuda"))
    s[:2] = torch.tensor([1e-8, 1.0], device="cuda")
    q = _unit(70, 768, gen)
    q[3] = 0
    (v, i), (pv, pi) = _tc_scan("s8s8", x8, s, q, 17, n_valid=29_900)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert (v[3] == 0).all() and torch.equal(i[3].cpu(), torch.arange(17, dtype=torch.int32))


def test_tc_f32_crafted_low_bits_within_1e4(gen):
    """Rows and queries whose f32 values all have low bits 0x0fff (a
    single TF32 pass drops ~2^-11 of each, all one way: ~1e-3 at the
    score near 1) and a query that copies a row: the 3xTF32 kernel stays
    within 1e-4 of the plain fp32 scan."""
    def low_bits(t):
        return ((t.view(torch.int32) & -0x2000) | 0x0FFF).view(torch.float32)

    x = low_bits(_unit(50_000, 768, gen))
    q = low_bits(_unit(64, 768, gen))
    q[0] = x[777]
    (v, i), (pv, pi) = _tc_scan("f32", x, None, q, 10)
    assert i[0, 0].item() == 777
    _check_like_plain(v, i, pv, pi, x.shape[0])
    head = ft._tf32_head
    one_pass = (head(q[:1]) @ head(x[777:778]).T).item()  # what a single TF32 pass scores
    assert abs(one_pass - pv[0, 0].item()) > 5e-4


@pytest.mark.parametrize("masked", [False, True])
def test_tc_s8s8_crafted_large_d_bitwise_plain(gen, masked):  # gen: skips without a card
    """D = 5760, int8 values ±64..127, 64 queries that copy rows (sums
    ~5.5e7, past fp32's 2^24; tests/test_torch_s8s8_exact.py holds the
    plain version to JAX on the same data): the kernel's exact s32 sums
    equal the plain version's exact float64 sums, bit for bit."""
    import numpy as np

    rng = np.random.default_rng(0)
    vals = (rng.integers(64, 128, (512, 5760)) * rng.choice([-1, 1], (512, 5760))).astype(np.int8)
    x8 = torch.from_numpy(vals).cuda()
    s = torch.from_numpy(rng.uniform(0.5, 2.0, 512).astype(np.float32)).cuda()
    q = x8[torch.from_numpy(rng.choice(512, 64, replace=False)).cuda()].to(torch.float32)
    qm = torch.full((64,), 0b111, dtype=torch.int32)
    qm[-1] = 0
    rm = torch.from_numpy((1 << rng.integers(0, 8, 512)).astype(np.int32))
    masks = (rm.cuda(), qm.cuda()) if masked else None
    (v, i), (pv, pi) = _tc_scan("s8s8", x8, s, q, 10, masks=masks)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert v.abs().max().item() > 2**24  # the sums past fp32's exact range



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


def _ivf_layout(gen, dtype, block_rows, n=20_000, d=768):
    from arxiv_rag_tpu_torch.ops.ivf import pad_index_for_ivf

    x = _unit(n, d, gen)
    scales = None
    if dtype == torch.int8:
        x, scales = quantize_int8(x)
    else:
        x = x.to(dtype)
    rm, _ = _masks(n, 2, gen)
    return pad_index_for_ivf(x, block_rows, scales=scales, row_masks=rm), n


def _k5_table(tiles, dead, block_rows, n):
    """Sorted random real blocks for the first tiles, dead padding; the
    next-to-last tile lists three adjacent blocks (the last one holds
    the ragged end of the rows below n_valid), the last tile only the
    dead block."""
    table = torch.full((tiles, 12), dead, dtype=torch.int32)
    for t in range(tiles - 2):
        real = torch.randperm(dead, generator=torch.Generator().manual_seed(t))[: 4 + 3 * t]
        table[t, : len(real)] = torch.sort(real).values
    last_real = (n - 1) // block_rows
    table[tiles - 2, :3] = torch.arange(last_real - 2, last_real + 1)
    return table


def _check_k5(gen, dtype, block_rows, q_block, k=10, d=768):
    """K5 against its plain version, unmasked and masked: within 1e-4,
    tie-tolerant recall 1.0, each row once in a query's list, the queries
    of the tile that lists only the dead block all (-inf, -1)."""
    from arxiv_rag_tpu_torch.ops import ivf as oivf

    (x, s, rm, dead), n = _ivf_layout(gen, dtype, block_rows, d=d)
    nq = 21 if q_block == 8 else 37  # a ragged last tile
    q = _unit(nq, d, gen)
    tiles = -(-nq // q_block)
    table = _k5_table(tiles, dead, block_rows, n)
    qm = torch.full((nq,), 0b111, dtype=torch.int32, device="cuda")
    for kw in ({}, {"row_masks": rm, "query_mask": qm}):
        if dtype == torch.int8:
            kw["scales"] = s
        ft.reset_launches()
        v, i = oivf._table_scan(x, table, q, k, n_valid=n, block_rows=block_rows,
                                q_block=q_block, **kw)
        assert ft.LAUNCHES["ivf_topk"] == 1
        pv, pi = oivf.ivf_topk_plain(x, table, q, k, n_valid=n, block_rows=block_rows,
                                     q_block=q_block, **kw)
        assert v.shape == (nq, k) and v.dtype == torch.float32 and i.dtype == torch.int32
        dead_q = slice((tiles - 1) * q_block, nq)
        assert (i[dead_q] == -1).all() and torch.isinf(v[dead_q]).all()
        for row in i.cpu().tolist():
            real = [r for r in row if r >= 0]
            assert len(set(real)) == len(real)
        _check_like_plain(v, i, pv, pi, n)


@pytest.mark.parametrize("q_block", [8, 16])
@pytest.mark.parametrize("block_rows", [1024, 128, 192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_k5_matches_plain(gen, dtype, block_rows, q_block):
    """Both tile heights the block tables take (``ivf_q_block``); 192-row
    blocks: every second 128-row slice overhangs its block's end."""
    _check_k5(gen, dtype, block_rows, q_block)


# (q_block, k, D): k = 1 and 128 (the lists' two capacities at their
# ends); D = 128 and the largest D the CUDA-core table scan took (4416 at
# q_block 8, 1408 at 16)
@pytest.mark.parametrize("q_block,k,d", [(8, 1, 768), (16, 1, 768), (8, 128, 768),
                                         (16, 128, 768), (8, 10, 128), (16, 10, 128),
                                         (8, 10, 4416), (16, 10, 1408)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_k5_edges_match_plain(gen, dtype, q_block, k, d):
    _check_k5(gen, dtype, 192 if k == 128 else 1024, q_block, k=k, d=d)


@pytest.mark.parametrize("dtype,masked", [(torch.bfloat16, False), (torch.int8, False),
                                          (torch.float32, True)])
def test_k6_bitwise_k5_without_host_sync(gen, dtype, masked):
    """The device plan covers the host plan's blocks: K6 equals K5 bit for
    bit, and its dispatch never waits for the device."""
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex
    from arxiv_rag_tpu_torch.index.store import build_index

    x = _unit(30_000, 768, gen)
    kw = {}
    if masked:
        codes = torch.randint(0, 8, (30_000,), generator=gen, device="cuda").cpu().numpy()
        kw["categories"] = [f"c{c}" for c in codes]
    name = {torch.int8: "int8", torch.bfloat16: "bfloat16", torch.float32: "float32"}[dtype]
    dense = build_index(x, dtype=name, **kw).to_device()
    ivf = IVFIndex.build(dense, 64, block_rows=1024, iters=3)
    q = _unit(32, 768, gen)
    qm = None
    if masked:
        qm = torch.full((32,), 0b101, dtype=torch.int32, device="cuda")
        qm[3] = 0
    hv, hl = ivf._search_table(q, ivf.plan_blocks(ivf.probe(q, 4), 8), 10, q_block=8,
                               query_mask=qm)
    torch.cuda.synchronize()
    ft.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dv, dl = ivf._search_device(q, 10, nprobe=4, q_block=8, query_mask=qm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ft.LAUNCHES["ivf_topk_device"] == 1 and ft.LAUNCHES["ivf_topk"] == 0
    assert torch.equal(dv, hv) and torch.equal(dl, hl)
    assert ft.LAUNCHES["fused_topk_int8_row"] == (1 if dtype == torch.int8 else 0)
    if masked:
        assert (dl[3] == -1).all() and (dl[:3] >= 0).all()


def test_table_scans_launch_the_table_kernel(gen):
    """Every block-table scan runs tc_table_kernel (and the merge)."""
    from torch.profiler import ProfilerActivity, profile

    from arxiv_rag_tpu_torch.ops import ivf as oivf

    (x, s, _, dead), n = _ivf_layout(gen, torch.int8, 1024)
    q = _unit(16, 768, gen)
    table = _k5_table(2, dead, 1024, n)
    run = lambda: oivf.ivf_topk_int8(x, s, table, q, 10, n_valid=n, block_rows=1024)  # noqa: E731
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()[0].cpu()
    names = [e.key for e in prof.key_averages()]
    assert any("tc_table_kernel" in n for n in names), names
    assert not any("tc_scan_kernel" in n for n in names), names


# -- slice 3: the W8A8 matmul (K7) and its fused-quantization form (K8) --------

_ENCODER_KN = [(768, 768), (768, 3072), (3072, 768)]


def _w8a8_operands(m, k, n, gen, x_dtype=torch.int8):
    from arxiv_rag_tpu_torch.ops import w8a8

    w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda").to(torch.int8)
    w_scale = torch.rand(n, generator=gen, device="cuda") * 1e-2 + 1e-4
    bias = torch.randn(n, generator=gen, device="cuda") * 0.5
    x = torch.randn(m, k, generator=gen, device="cuda")
    if x_dtype == torch.int8:
        return (*w8a8.quantize_activations(x), w_q, w_scale, bias)
    return x.to(x_dtype), w_q, w_scale, bias


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", _ENCODER_KN)
@pytest.mark.parametrize("m", [8192, 1000])  # 1000: a ragged last row block
def test_k7_bitwise_plain(gen, m, k, n, out_dtype):
    from arxiv_rag_tpu_torch.ops import w8a8

    x_q, a_scale, w_q, w_scale, bias = _w8a8_operands(m, k, n, gen)
    got = w8a8.w8a8_matmul(x_q, a_scale, w_q, w_scale, bias, out_dtype=out_dtype)
    want = w8a8.w8a8_matmul_plain(x_q, a_scale, w_q, w_scale, bias, out_dtype=out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", _ENCODER_KN)
def test_k8_bitwise_plain_and_quantize_then_k7(gen, k, n, x_dtype):
    from arxiv_rag_tpu_torch.ops import w8a8

    x, w_q, w_scale, bias = _w8a8_operands(4100, k, n, gen, x_dtype)
    x[3] = 0  # an all-zero row: the 1e-8 floor
    w8a8.reset_launches()
    got = w8a8.w8a8_matmul_fused_quant(x, w_q, w_scale, bias.to(x_dtype), out_dtype=x_dtype)
    assert w8a8.LAUNCHES["w8a8_matmul_fused_quant"] == 1
    want = w8a8.w8a8_matmul_fused_quant_plain(x, w_q, w_scale, bias.to(x_dtype),
                                              out_dtype=x_dtype)
    assert torch.equal(got, want)
    x_q, a_scale = w8a8.quantize_activations(x)
    assert torch.equal(got, w8a8.w8a8_matmul(x_q, a_scale, w_q, w_scale, bias.to(x_dtype),
                                             out_dtype=x_dtype))
    assert w8a8.LAUNCHES == {"w8a8_matmul": 1, "w8a8_matmul_fused_quant": 1}


def _k8_and_k7_bitwise(x, w_q, w_scale, bias, out_dtype):
    """K8 against its plain version and against quantize → K7 (the kernel
    at any K % 16 == 0 through the internal launch; the public K7 keeps
    the reference's K ≤ 4096 and multiple-of-128 guards)."""
    from arxiv_rag_tpu_torch.ops import w8a8

    got = w8a8._launch(x, None, w_q, w_scale, bias, out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got, w8a8.w8a8_matmul_fused_quant_plain(x, w_q, w_scale, bias,
                                                               out_dtype=out_dtype))
    x_q, a_scale = w8a8.quantize_activations(x)
    k7 = w8a8._launch(x_q, a_scale, w_q, w_scale, bias, out_dtype)
    assert torch.equal(k7, w8a8.w8a8_matmul_plain(x_q, a_scale, w_q, w_scale, bias,
                                                  out_dtype=out_dtype))
    assert torch.equal(got, k7)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [3584, 4096, 6272])
def test_k8_streamed_form_past_the_resident_limit(gen, k, x_dtype):
    """Past the K where a block's 128 rows fit in shared memory (896 on an
    H100), K8 streams the rows' K slices through the ring: the same bits,
    up to the wrapper's old limit K = 6272."""
    from arxiv_rag_tpu_torch.ops import w8a8

    assert w8a8._device_plan(1000, 384, k, True, torch.device("cuda")).form == w8a8.STREAMED
    x, w_q, w_scale, bias = _w8a8_operands(1000, k, 384, gen, x_dtype)
    _k8_and_k7_bitwise(x, w_q, w_scale, bias, torch.float32)


def test_w8a8_smem_matches_the_kernel(gen):
    """The wrapper's plan counts a block's shared memory as the kernel
    does, for both forms and every stage count."""
    from arxiv_rag_tpu_torch.ops import w8a8

    lib = w8a8._lib()
    for k in range(16, 6273, 16):
        for form in (w8a8.STREAMED, w8a8.RESIDENT):
            for stages in (2, 3, 4):
                assert lib.arag_w8a8_smem(form, stages, k) == w8a8.smem_bytes(form, stages, k)


@pytest.mark.parametrize("bias_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 752, 200), (17, 752, 201), (17, 784, 768),
                                   (1000, 768, 200), (17, 2064, 200), (1000, 1296, 520)])
def test_w8a8_edge_shapes_bitwise(gen, m, k, n, x_dtype, out_dtype, bias_dtype):
    """K ≡ 16 (mod 32) (752, 784, 2064, 1296: the last k-step half zeros),
    N not a multiple of the 256-column tile (201: rows not 16-byte aligned,
    copied out without TMA), M of 1, 17 and 1,000 (ragged row blocks),
    every bias and output kind, an all-zero row, both forms."""
    x, w_q, w_scale, bias = _w8a8_operands(m, k, n, gen, x_dtype)
    x[m // 2] = 0  # an all-zero row: the 1e-8 floor, all zeros
    bias = None if bias_dtype is None else bias.to(bias_dtype)
    _k8_and_k7_bitwise(x, w_q, w_scale, bias, out_dtype)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_w8a8_round_half_to_even_at_exact_quotients(gen, x_dtype):
    """Rows whose max|x| is 127 (scale exactly f32(127 · f32(1/127))) and
    whose values sit on exact .5 quotients: rintf rounds half to even,
    as torch.round and the reference do."""
    from arxiv_rag_tpu_torch.ops import w8a8

    m, k, n = 300, 768, 256
    halves = torch.arange(-127, 127, device="cuda", dtype=torch.float32) + 0.5
    x = halves[torch.randint(0, halves.numel(), (m, k), generator=gen, device="cuda")]
    x[:, 0] = 127.0
    x = x.to(x_dtype)
    _, w_q, w_scale, bias = _w8a8_operands(m, k, n, gen, x_dtype)
    x_q, _ = w8a8.quantize_activations(x)
    frac = (x.to(torch.float32) - x.to(torch.float32).floor()) == 0.5
    assert frac.any() and (x_q.to(torch.int32)[frac] % 2 == 0).all()
    _k8_and_k7_bitwise(x, w_q, w_scale, bias, torch.float32)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [768, 3072])
def test_w8a8_sums_up_to_127_squared_k(gen, k, out_dtype):
    """Rows of one value quantize to all 127; against weights of ±127 the
    sums reach ±127^2 · K (past 2^24 at K = 3072, where float(acc) rounds),
    beside rows of small sums: bitwise."""
    m, n = 300, 512
    x = torch.full((m, k), 0.75, device="cuda")
    x[::2] *= -1
    x[100:] = torch.randn(m - 100, k, generator=gen, device="cuda")
    w_q = torch.full((n, k), 127, dtype=torch.int8, device="cuda")
    w_q[1::2] = -127
    w_q[256:] = torch.randint(-1, 2, (n - 256, k), generator=gen, device="cuda").to(torch.int8)
    w_scale = torch.rand(n, generator=gen, device="cuda") * 1e-6 + 1e-7
    _k8_and_k7_bitwise(x.to(torch.bfloat16), w_q, w_scale, None, out_dtype)


@pytest.mark.parametrize("k,form", [(768, "RESIDENT"), (896, "RESIDENT"), (912, "STREAMED"),
                                    (3072, "STREAMED")])
def test_each_form_forced_by_its_shape(gen, k, form):
    """The plan picks the form from K alone (resident while 128 rows of K
    fit beside two stages): each form runs bitwise, at M = 8,192 with N
    split among blocks to fill the card."""
    from arxiv_rag_tpu_torch.ops import w8a8

    dev = torch.device("cuda")
    p = w8a8._device_plan(8192, 768, k, True, dev)
    assert p.form == getattr(w8a8, form)
    assert p.blocks >= torch.cuda.get_device_properties(dev).multi_processor_count
    x, w_q, w_scale, bias = _w8a8_operands(8192, k, 768, gen, torch.bfloat16)
    _k8_and_k7_bitwise(x, w_q, w_scale, bias.to(torch.bfloat16), torch.bfloat16)


def test_k7_dequant_rounds_once_at_a_float64_tie(gen):
    """t · w_scale + bias whose float64 sum falls on an fp32 midpoint
    while the exact sum lies below it: the kernel's FMA and the plain
    version both round the exact sum (1 + 2^-23), not the tie (1 + 2^-22)."""
    from arxiv_rag_tpu_torch.ops import w8a8

    x_q = torch.zeros(8, 128, dtype=torch.int8, device="cuda")
    x_q[:, 0] = 1
    w_q = torch.zeros(128, 128, dtype=torch.int8, device="cuda")
    w_q[:, 0] = 1
    w_q[1::2, 0] = -1
    a_scale = torch.full((8,), 1 + 2.0**-23, device="cuda")  # t = 1 + 2^-23
    w_scale = torch.full((128,), (2**23 - 1) * 2.0**-47, device="cuda")
    bias = torch.full((128,), 1 + 2.0**-23, device="cuda")
    bias[1::2] *= -1
    got = w8a8.w8a8_matmul(x_q, a_scale, w_q, w_scale, bias)
    assert torch.equal(got, w8a8.w8a8_matmul_plain(x_q, a_scale, w_q, w_scale, bias))
    assert (got.abs() == 1 + 2.0**-23).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantizations_on_the_card_bitwise_cpu(gen, dtype):
    """quantize_params_int8, quantize_int8 and quantize_activations give on
    the card the bits they give on the CPU, where tests/test_torch_w8a8.py
    and tests/test_torch_ops.py hold them against the JAX package. The
    scale divisions are quotients there too: the product with a
    reciprocal, which CUDA takes for a CPU-scalar divisor, differs from
    them on some of these rows."""
    import copy

    from arxiv_rag_tpu_torch.models import mpnet
    from arxiv_rag_tpu_torch.ops import w8a8

    def bits(t):
        return t.cpu().contiguous().view(torch.uint8)

    model = mpnet.random_model(mpnet.ModelConfig(num_hidden_layers=2), seed=5,
                               param_dtype=dtype, compute_dtype=dtype)
    on_card = mpnet.quantize_params_int8(model).state_dict()
    on_cpu = mpnet.quantize_params_int8(copy.deepcopy(model).cpu()).state_dict()
    assert on_card.keys() == on_cpu.keys()
    for key, t in on_card.items():
        assert t.device.type == "cuda" and t.dtype == on_cpu[key].dtype, key
        assert torch.equal(bits(t), bits(on_cpu[key])), key
    absmax = torch.stack([lin.weight.to(torch.float32).abs().amax(dim=1)
                          for layer in model.layers for lin in (layer.attn.q, layer.ffn.out)])
    assert ((absmax / 127.0).cpu() != absmax.cpu() / 127.0).any()
    x = torch.randn(70_001, 768, generator=gen, device="cuda").to(getattr(torch, dtype))
    for fn in (quantize_int8, w8a8.quantize_activations):
        for got, want in zip(fn(x), fn(x.cpu())):
            assert torch.equal(bits(got), bits(want)), fn.__name__


@pytest.mark.parametrize("k,n", [(64, 100), (48, 257), (16, 8)])
def test_w8a8_dense_without_the_128_rule(gen, k, n):
    """The encoder's entry takes any K % 16 == 0 and any N (ragged columns,
    no bias), as the reference's XLA route does."""
    from arxiv_rag_tpu_torch.ops import w8a8

    x, w_q, w_scale, _ = _w8a8_operands(3 * 37, k, n, gen, torch.bfloat16)
    x = x.reshape(3, 37, k)
    got = w8a8.w8a8_dense(x, w_q, w_scale)
    assert got.shape == (3, 37, n) and got.dtype == torch.bfloat16
    assert torch.equal(got, w8a8.w8a8_dense_plain(x, w_q, w_scale))
    with pytest.raises(ValueError, match="K % 16"):
        w8a8.w8a8_dense(torch.zeros(4, 40, device="cuda"),
                        torch.zeros(n, 40, dtype=torch.int8, device="cuda"), w_scale)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_quantized_encoder_kernel_route_bitwise_plain_route(gen, compute_dtype, monkeypatch):
    """The W8A8 encoder on the card through K8 equals the same quantized
    model with every dense layer through the plain version, bit for bit."""
    from arxiv_rag_tpu_torch.models import mpnet
    from arxiv_rag_tpu_torch.ops import w8a8

    cfg = mpnet.ModelConfig(num_hidden_layers=2)
    model = mpnet.quantize_params_int8(mpnet.random_model(cfg, seed=3, param_dtype=compute_dtype,
                                                          compute_dtype=compute_dtype))
    ids = torch.randint(3, cfg.vocab_size, (8, 128), generator=gen, device="cuda")
    mask = torch.ones_like(ids)
    mask[2, 70:] = 0
    ids[2, 70:] = cfg.pad_token_id
    w8a8.reset_launches()
    got = model.encode(ids, mask)
    assert w8a8.LAUNCHES["w8a8_matmul_fused_quant"] == 6 * cfg.num_hidden_layers
    monkeypatch.setattr(mpnet, "_dense_int8", lambda x, lin: w8a8.w8a8_dense_plain(
        x, lin.weight, lin.scale, lin.bias, out_dtype=x.dtype))
    want = model.encode(ids, mask)
    assert torch.equal(got, want)


# -- the flagship route: the cross-encoder and the hybrid merge on the card ---------


def _pairs_batch(gen, vocab, b=6, s=96):
    ids = torch.randint(5, vocab, (b, s), generator=gen, device="cuda")
    mask = torch.ones_like(ids)
    mask[1, 40:] = 0
    mask[4, 7:] = 0
    ids[mask == 0] = 0
    types = torch.zeros_like(ids)
    types[:, 20:] = 1
    return ids, mask, types


def test_bert_fp32_on_the_card_matches_the_cpu(gen):
    """MiniLM-L6 widths in fp32: the card's forward (TF32 off) within
    1e-4 of the CPU's on the same weights; classify and encode_sentences
    too."""
    import copy

    from arxiv_rag_tpu_torch.models.bert import BertConfig, random_bert

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = BertConfig(vocab_size=1000)
    model = random_bert(cfg, seed=1, param_dtype=torch.float32, compute_dtype=torch.float32)
    cpu = copy.deepcopy(model).cpu()
    ids, mask, types = _pairs_batch(gen, cfg.vocab_size)
    args_cpu = (ids.cpu(), mask.cpu(), types.cpu())
    assert (model(ids, mask, types).cpu() - cpu(*args_cpu)).abs().max().item() <= 1e-4
    assert (model.classify(ids, mask, types).cpu() - cpu.classify(*args_cpu)).abs().max() <= 1e-4
    assert (model.encode_sentences(ids, mask).cpu()
            - cpu.encode_sentences(ids.cpu(), mask.cpu())).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_score_pairs_on_the_card(gen, dtype):
    """The reranker on the card against the same reranker on the CPU: fp32
    within 1e-4, bf16 within 2e-2 (bf16 rounding of every layer); the
    same batches, buckets and FLOP counts either way."""
    import copy

    from arxiv_rag_tpu_torch.models.bert import BertConfig, random_bert
    from arxiv_rag_tpu_torch.search.rerank import CrossEncoderReranker
    from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer

    tok = WordPieceTokenizer.toy()
    cfg = BertConfig(vocab_size=len(tok.vocab), num_hidden_layers=2, pad_token_id=tok.pad_id)
    model = random_bert(cfg, seed=2, param_dtype=dtype, compute_dtype=dtype)
    pairs = [(f"query {i % 3} words", "passage " + "text words " * (3 + 11 * (i % 4)))
             for i in range(37)]
    card = CrossEncoderReranker(model, tok, batch_size=16)
    cpu = CrossEncoderReranker(copy.deepcopy(model).cpu(), tok, batch_size=16)
    got, want = card.score_pairs(pairs), cpu.score_pairs(pairs)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert abs(got - want).max() <= tol
    assert (card.stats.batches, card.stats.buckets, card.stats.flops_padded) == \
           (cpu.stats.batches, cpu.stats.buckets, cpu.stats.flops_padded)
    window = card.rerank_window(["query 1 words"], [[p for _, p in pairs]], 5)
    assert len(window[0][1]) == 5


def _plain_merge(dv, dr, window, k, alpha, cat_bits=None, row_masks=None):
    """The reference's hybrid merge (search/engine.py:668-724) in numpy."""
    import numpy as np

    out = []
    for i in range(dv.shape[0]):
        keep = (dr[i] >= 0) & np.isfinite(dv[i])
        d_v, d_r = dv[i][keep], dr[i][keep].astype(np.int64)
        b_v, b_r = window[i]
        if cat_bits is not None:
            inside = (row_masks[b_r] & cat_bits) != 0
            b_v, b_r = b_v[inside], b_r[inside]

        def norm(v):
            if len(v) == 0:
                return v
            lo, hi = float(v.min()), float(v.max())
            if hi > lo:
                return (v - lo) / (hi - lo)
            return np.zeros_like(v) if hi == 0.0 else np.ones_like(v)

        rows, where = np.unique(np.concatenate([d_r, b_r]), return_inverse=True)
        dense, sparse = np.zeros(len(rows), np.float32), np.zeros(len(rows), np.float32)
        dense[where[:len(d_r)]] = norm(d_v)
        sparse[where[len(d_r):]] = norm(b_v)
        comb = alpha * dense + (1.0 - alpha) * sparse
        kk = min(k, len(rows))
        top = np.argpartition(-comb, kk - 1)[:kk]
        top = top[np.argsort(-comb[top], kind="stable")]
        out.append([(int(r), float(v)) for r, v in zip(rows[top], comb[top])])
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_hybrid_window_bitwise_plain_recomputation(gen, masked):
    """A hybrid window on the card (K2, or K4 s8s8 with categories) equals
    the plain int8 scan + the BM25 window + the reference's merge in
    numpy, rows and scores bit for bit."""
    import numpy as np

    from arxiv_rag_tpu_torch.index.store import build_index
    from arxiv_rag_tpu_torch.search.bm25 import BM25Index
    from arxiv_rag_tpu_torch.search.engine import SearchEngine

    n, d, k, c = 20_000, 768, 10, 50
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(3000)]
    texts = [" ".join(words[j] for j in rng.integers(0, 3000, int(rng.integers(20, 40))))
             for _ in range(n)]
    cats = [f"cs.{i % 5}" for i in range(n)]
    idx = build_index(_unit(n, d, gen), categories=cats, dtype="int8").to_device()
    queries = [" ".join(words[j] for j in rng.integers(0, 3000, 6)) for _ in range(40)]
    q = _unit(len(queries), d, gen)

    class Embedder:
        def encode_texts(self, texts):
            return q[: len(texts)].cpu().numpy()

    bm25 = BM25Index.build(texts)
    engine = SearchEngine(idx, embedder=Embedder(), bm25=bm25)
    want_cats = ["cs.1", "cs.3"] if masked else None
    ft.reset_launches()
    hits = engine.search(queries, k=k, categories=want_cats, hybrid_alpha=0.7)
    assert ft.LAUNCHES["fused_topk_masked" if masked else "fused_topk_int8"] == 1
    if masked:
        bits = idx.category_mask(want_cats)
        qmask = torch.full((len(queries),), int(np.uint32(bits).view(np.int32)),
                           dtype=torch.int32, device="cuda")
        dv, dr = ft.fused_topk_int8_masked_plain(idx._device_values, idx._device_scales,
                                                 idx._device_masks, qmask, q, c,
                                                 n_valid=idx._n_valid)
    else:
        bits = None
        dv, dr = ft.fused_topk_int8_plain(idx._device_values, idx._device_scales, q, c,
                                          n_valid=idx._n_valid)
    want = _plain_merge(dv.cpu().numpy(), dr.cpu().numpy(), bm25.topk_batch(queries, c), k,
                        0.7, bits, idx.row_masks)
    assert [[(h.row, h.score) for h in row] for row in hits] == want


def _index_bits(idx):
    """(values bits, scales, row masks, chunk ids) of an index, on the host."""
    v = idx.values.cpu().contiguous()
    return (v.view(torch.uint8), None if idx.scales is None else idx.scales.cpu(),
            idx.row_masks, idx.chunk_ids)


def _same_index(a, b) -> bool:
    va, sa, ma, ia = _index_bits(a)
    vb, sb, mb, ib = _index_bits(b)
    return (torch.equal(va, vb) and (sa is None) == (sb is None)
            and (sa is None or torch.equal(sa, sb)) and ia == ib
            and ((ma is None and mb is None) or (ma == mb).all()))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_append_on_the_card(gen, dtype, tmp_path):
    """``append_index`` on the card (its default) is bitwise a full build
    on the card, new category at bit 31 included, and bitwise the CPU's
    append in values and scales, normalized or not: the row norms are
    numpy's on both, and the division and the quantization divide by a
    tensor."""
    import numpy as np

    from arxiv_rag_tpu_torch.index.store import DenseIndex, append_index, build_index

    n, split, d = 9000, 6100, 256
    x = torch.randn(n, d, generator=gen, device="cuda") * 3
    names = [f"c{i:02d}" for i in range(31)]
    cats = [names[i % 31] for i in range(split)] + ["zz" if i % 7 else "c03"
                                                    for i in range(n - split)]
    ids = [f"r{i}" for i in range(n)]
    for normalize in (True, False):
        d_card, d_cpu = tmp_path / f"card{normalize}", tmp_path / f"cpu{normalize}"
        base = build_index(x[:split], categories=cats[:split], dtype=dtype,
                           normalize=normalize, chunk_ids=ids[:split])
        base.save(d_card, rows_per_shard=4096)
        base.save(d_cpu, rows_per_shard=4096)
        grown = append_index(d_card, x[split:], categories=cats[split:], chunk_ids=ids[split:])
        assert grown.categories[31] == "zz"
        full = build_index(x, categories=cats, category_names=grown.categories, dtype=dtype,
                           normalize=normalize, chunk_ids=ids)
        assert _same_index(grown, full)
        on_cpu = append_index(d_cpu, x[split:].cpu().numpy(), categories=cats[split:],
                              chunk_ids=ids[split:], device="cpu")
        assert _same_index(grown, on_cpu)
        host = build_index(x.cpu().numpy(), categories=cats, category_names=grown.categories,
                           dtype=dtype, normalize=normalize, chunk_ids=ids)
        assert _same_index(full, host)
        on = DenseIndex.load(d_card).to_device()
        assert int(on._device_masks[split + 1]) == -(1 << 31)
        assert np.array_equal(on.row_masks, grown.row_masks)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_extend_on_the_card_equals_a_full_build(gen, dtype, tmp_path):
    """``IVFIndex.extend`` on the card: the perm, offsets and layout of
    ``build(centroids=)`` there, the new rows assigned in the full
    build's batches."""
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex
    from arxiv_rag_tpu_torch.index.store import append_index, build_index

    n, split, d, c = 40_000, 29_000, 128, 64
    x = torch.randn(n, d, generator=gen, device="cuda")
    build_index(x[:split], dtype=dtype).save(tmp_path)
    base = build_index(x[:split], dtype=dtype)
    ivf0 = IVFIndex.build(base, c, block_rows=256, iters=3)
    ivf0.save(tmp_path)
    grown = append_index(tmp_path, x[split:])
    ext = IVFIndex.extend(tmp_path, grown, assign_batch=16_384)
    full = IVFIndex.build(grown, c, block_rows=256, centroids=ivf0.centroids,
                          assign_batch=16_384)
    assert ext.values.device.type == "cuda"
    assert (ext.perm == full.perm).all() and (ext.offsets == full.offsets).all()
    assert torch.equal(ext.values.view(torch.uint8), full.values.view(torch.uint8))
    reloaded = IVFIndex.load(tmp_path, grown)
    assert (reloaded.perm == full.perm).all()


# -- training (the encoder's backward and the fp32 step) ----------------------------

TRAIN_CFG = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=64, max_position_embeddings=32)  # tests/test_train.py


def _bf16_steps(x):
    mag = x.abs().to(torch.bfloat16).to(torch.float32)
    return torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7),
                       torch.zeros_like(mag))


@pytest.mark.parametrize("shape_a,shape_b", [((8, 64, 768), (768, 3072)),
                                             ((8, 64, 3072), (3072, 768)),
                                             ((8, 12, 64, 64), (8, 12, 64, 64))])
def test_matmul_f32_backward_on_the_card_matches_the_cpu(gen, shape_a, shape_b):
    """The card's ``_MatmulF32`` backward (an fp32 GEMM of the fp32
    cotangent and the other bf16 operand, cast to bf16) against the
    CPU's autograd through its cast and fp32 product: before the cast
    within fp32 summation order of the float64 product (K·2^-24 of the
    sum of |terms|, K the contracted length); after it, ≥ 99% of the
    bf16 gradients equal (0.1% differ on the card) and the rest one bf16
    step apart, plus twice that order where a sum cancels to near 0
    (there the step of the tiny result is finer than the order's
    error)."""
    from arxiv_rag_tpu_torch.models import mpnet

    a = torch.randn(shape_a, generator=gen, device="cuda").to(torch.bfloat16)
    b = (torch.randn(shape_b, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    a.requires_grad_()
    b.requires_grad_()
    out = mpnet._matmul_f32(a, b)
    ct = torch.randn(out.shape, generator=gen, device="cuda") * 1e-3
    out.backward(ct)
    a_cpu = a.detach().cpu().requires_grad_()
    b_cpu = b.detach().cpu().requires_grad_()
    mpnet._matmul_f32(a_cpu, b_cpu).backward(ct.cpu())
    ad, bd = a.detach(), b.detach()
    if b.dim() == 2:  # the dense kernel's gradient sums over every row of a
        x_b, z_b, k_b = ad.reshape(-1, b.shape[0]).T, ct.reshape(-1, b.shape[1]), ad.numel() // b.shape[0]
    else:
        x_b, z_b, k_b = ad.transpose(-1, -2), ct, a.shape[-2]
    for name, x, z, k, grad, want in (
            ("a", ct, bd.transpose(-1, -2), b.shape[-1], a.grad, a_cpu.grad),
            ("b", x_b, z_b, k_b, b.grad, b_cpu.grad)):
        x64, z64 = x.cpu().to(torch.float64), z.cpu().to(torch.float64)
        order = (k * 2.0**-24 * (x64.abs() @ z64.abs())).reshape(grad.shape)
        pre = mpnet._product_f32(x, z).cpu().to(torch.float64).reshape(grad.shape)
        assert (pre - (x64 @ z64).reshape(grad.shape)).abs().le(order).all(), name
        g, w = grad.cpu().to(torch.float32), want.to(torch.float32)
        assert grad.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.equal(grad.cpu(), pre.to(torch.bfloat16)), name
        diff = (g - w).abs()
        step = _bf16_steps(torch.maximum(g.abs(), w.abs()))
        assert bool((diff <= step + 2 * order.to(torch.float32)).all()), name
        assert float((diff == 0).to(torch.float32).mean()) >= 0.99, name


def test_fp32_train_step_on_the_card_matches_the_cpu(gen):
    """One fp32 step at the reference's test config on the card and on
    the CPU from the same weights: loss and every parameter within 1e-5
    (tests/test_train.py's bound for two ways of computing a step); the
    grad-enabled forward on the card bitwise its ``no_grad`` forward."""
    import numpy as np

    from arxiv_rag_tpu_torch.models.mpnet import MPNet, ModelConfig
    from arxiv_rag_tpu_torch.train import make_train_step

    cfg = ModelConfig(**TRAIN_CFG)
    weights = MPNet(cfg).reset_parameters(torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(1)
    q = rng.integers(4, cfg.vocab_size, (8, 12))
    p = np.where(rng.random(q.shape) < 0.15, rng.integers(4, cfg.vocab_size, q.shape), q)
    mask = np.ones_like(q)
    mask[0, 7:] = 0
    out = {}
    for dev in ("cpu", "cuda"):
        init_state, train_step = make_train_step(cfg, learning_rate=3e-4,
                                                 compute_dtype=torch.float32, device=dev)
        state = init_state(weights)
        state, m = train_step(state, q, mask, p, mask)
        out[dev] = float(m["loss"]), {k: v.detach().cpu() for k, v in state.params.items()}
        if dev == "cuda":
            ids, msk = (torch.from_numpy(t).cuda() for t in (q, mask))
            assert torch.equal(state.model.hidden(ids, msk).detach(), state.model(ids, msk))
    assert abs(out["cpu"][0] - out["cuda"][0]) <= 1e-5
    for name, want in out["cpu"][1].items():
        assert float((out["cuda"][1][name] - want).abs().max()) <= 1e-5, name


# -- sharded retrieval on one card: a mesh that repeats cuda:0 -------------------


def _card_mesh(nd=4):
    from arxiv_rag_tpu_torch.parallel import DeviceMesh

    return DeviceMesh(["cuda:0"] * nd)


@pytest.mark.parametrize("kind", ["s8s8", "bf16", "masked s8s8"])
def test_sharded_equals_single_device_on_the_card(gen, kind):
    """4 shards on one card launch 4 scans and 1 merge, and give the
    single-device kernel's values and ids bitwise (s8s8: given the
    sharded route's query scale, the reference's quotient; against the
    single-device product the ids are equal)."""
    from arxiv_rag_tpu_torch.parallel import shard_index_rows, sharded_topk

    n, n_valid = 70_001, 69_964
    x, q = _unit(n, 768, gen), _unit(37, 768, gen)
    mesh = _card_mesh()
    kw, mask = {}, {}
    if kind.startswith("masked"):
        codes = torch.randint(0, 8, (n,), generator=gen, device="cuda", dtype=torch.int32)
        rm = torch.ones_like(codes) << codes
        qm = torch.full((37,), 0b101, dtype=torch.int32, device="cuda")
        qm[3] = 0
        mask = {"row_masks": rm, "query_mask": qm}
        kw = {"row_masks": shard_index_rows(rm, mesh)[0], "query_mask": qm}
    if kind.endswith("s8s8"):
        values, scales = quantize_int8(x)
        kw["scales"] = shard_index_rows(scales, mesh)[0]
        counter = "fused_topk_masked" if mask else "fused_topk_int8"

        def single(**extra):
            if mask:
                return ft.fused_topk_int8_masked(values, scales, mask["row_masks"],
                                                 mask["query_mask"], q, 10, n_valid=n_valid,
                                                 **extra)
            return ft.fused_topk_int8(values, scales, q, 10, n_valid=n_valid, **extra)
    else:
        values, counter = x.to(torch.bfloat16), "fused_topk"

        def single(**extra):
            return ft.fused_topk(values, q, 10, n_valid=n_valid)
    shards, _ = shard_index_rows(values, mesh)
    ft.reset_launches()
    v, i = sharded_topk(shards, q, 10, mesh, n_valid=n_valid, **kw)
    assert ft.LAUNCHES[counter] == 4 and ft.LAUNCHES["topk_merge"] == 1
    sv, si = single(**({"query_scale": "quotient"} if kind.endswith("s8s8") else {}))
    assert torch.equal(v, sv) and torch.equal(i, si)
    assert int(i.max()) < n_valid
    if kind.endswith("s8s8"):
        pv, pi = single()
        assert torch.equal(i, pi) and torch.allclose(v, pv, rtol=2.0**-22, atol=0)
    if mask:
        assert (i[3] == -1).all()


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_sharded_ivf_on_the_card(gen, dtype):
    """ShardedIVF over 4 shards of one card: the device plan bitwise the
    host plan (partial and full probe), and at full probe bitwise the
    single-device IVF; one table scan per shard and one merge a search."""
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex
    from arxiv_rag_tpu_torch.index.store import build_index
    from arxiv_rag_tpu_torch.parallel import ShardedIVF

    dense = build_index(_unit(30_000, 768, gen), dtype=dtype).to_device()
    ivf = IVFIndex.build(dense, 64, block_rows=1024, iters=3).to_device()
    q = _unit(32, 768, gen)
    mesh = _card_mesh()
    siv = ShardedIVF.build(ivf, mesh.size)
    for nprobe in (4, 64):
        ft.reset_launches()
        hv, hr = siv.search(q, 10, mesh, nprobe=nprobe, plan="host")
        assert ft.LAUNCHES["ivf_topk"] == 4 and ft.LAUNCHES["topk_merge"] == 1
        dv, dr = siv.search(q, 10, mesh, nprobe=nprobe, plan="device")
        assert ft.LAUNCHES["ivf_topk_device"] == 4 and ft.LAUNCHES["topk_merge"] == 2
        assert (dv == hv).all() and (dr == hr).all()
    iv, ir = ivf.search(q, 10, nprobe=64, plan="host")
    assert (hv == iv).all() and (hr == ir).all()


# -- several processes on the one card (parallel/distributed.py) --------------------

_DIST_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from arxiv_rag_tpu_torch.ops import fused_topk as ft
from arxiv_rag_tpu_torch.ops.quant import quantize_int8
from arxiv_rag_tpu_torch.parallel import (
    global_mesh, init_distributed, shard_index_rows, sharded_topk)

rank, world, store, backend = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
kw = {"backend": backend, "device": "cuda:0"} if backend == "gloo" else {}
assert init_distributed(init_method=f"file://{store}", num_processes=world, process_id=rank,
                        **kw)
gen = torch.Generator(device="cuda").manual_seed(0)
x = torch.randn(70_001, 768, generator=gen, device="cuda")
x = x / x.norm(dim=1, keepdim=True)
q = torch.randn(37, 768, generator=gen, device="cuda")
q = q / q.norm(dim=1, keepdim=True)
values, scales = quantize_int8(x)
mesh = global_mesh()
ft.reset_launches()
bv, bi = sharded_topk(shard_index_rows(x.to(torch.bfloat16), mesh)[0], q, 10, mesh,
                      n_valid=69_964)
sv, si = sharded_topk(shard_index_rows(values, mesh)[0], q, 10, mesh, n_valid=69_964,
                      scales=shard_index_rows(scales, mesh)[0])
torch.save({"bf16": (bv.cpu(), bi.cpu()), "s8s8": (sv.cpu(), si.cpu()),
            "launches": dict(ft.LAUNCHES), "backend": dist.get_backend(),
            "home": str(mesh.home)}, f"{store}.rank{rank}.pt")
dist.destroy_process_group()
print(json.dumps({"rank": rank}))
"""


def _dist_run(tmp_path, world, backend):
    import subprocess
    import sys
    from pathlib import Path

    store = tmp_path / f"store-{backend}-{world}"
    procs = [subprocess.Popen([sys.executable, "-c", _DIST_WORKER,
                               str(Path(__file__).resolve().parents[1]), str(r), str(world),
                               str(store), backend],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return [torch.load(f"{store}.rank{r}.pt") for r in range(world)]


def _in_process(gen_seed, world):
    from arxiv_rag_tpu_torch.parallel import shard_index_rows, sharded_topk

    gen = torch.Generator(device="cuda").manual_seed(gen_seed)
    x, q = _unit(70_001, 768, gen), _unit(37, 768, gen)
    values, scales = quantize_int8(x)
    mesh = _card_mesh(world)
    bv, bi = sharded_topk(shard_index_rows(x.to(torch.bfloat16), mesh)[0], q, 10, mesh,
                          n_valid=69_964)
    sv, si = sharded_topk(shard_index_rows(values, mesh)[0], q, 10, mesh, n_valid=69_964,
                          scales=shard_index_rows(scales, mesh)[0])
    return {"bf16": (bv.cpu(), bi.cpu()), "s8s8": (sv.cpu(), si.cpu())}


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_gloo_processes_on_the_card(gen, tmp_path, world):
    """2 and 4 gloo processes sharing cuda:0, each scanning its own shard:
    bf16 and s8s8 bitwise the in-process mesh of the same size on every
    rank; each rank launched one scan of each kind and two merges."""
    ranks = _dist_run(tmp_path, world, "gloo")
    want = _in_process(0, world)
    for r in ranks:
        assert r["backend"] == "gloo" and r["home"] == "cuda:0"
        assert r["launches"]["fused_topk"] == 1 and r["launches"]["fused_topk_int8"] == 1
        assert r["launches"]["topk_merge"] == 2
        for kind in ("bf16", "s8s8"):
            assert all(torch.equal(a, b) for a, b in zip(r[kind], want[kind])), kind


def test_distributed_nccl_group_of_one(gen, tmp_path):
    """A group of one on the card takes NCCL by default, and its gather
    (an NCCL all_gather) gives the in-process one-entry mesh bitwise."""
    (r,) = _dist_run(tmp_path, 1, "nccl")
    assert r["backend"] == "nccl"
    want = _in_process(0, 1)
    for kind in ("bf16", "s8s8"):
        assert all(torch.equal(a, b) for a, b in zip(r[kind], want[kind])), kind


def _semantic_cfg(root, ckpt, threshold=0.7):
    from arxiv_rag_tpu_torch.config import load_config

    return load_config(overrides={"paths.root": str(root), "extraction.cache_enabled": False,
                                  "chunking.method": "semantic",
                                  "chunking.semantic_model": str(ckpt),
                                  "chunking.semantic_threshold": threshold}, environ={})


def _sentence_checkpoint(path):
    """A seeded random 2-layer, 768-wide encoder (the toy char vocab)."""
    from arxiv_rag_tpu_torch.models.convert import save_checkpoint
    from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model

    cfg = ModelConfig(vocab_size=193, num_hidden_layers=2)
    model = random_model(cfg, seed=0, param_dtype=torch.float32, device="cpu")
    save_checkpoint(path, model.state_dict(), cfg)
    return cfg


def _paper_text(seed, n=120):
    import numpy as np

    rng = np.random.default_rng(seed)
    words = "dense retrieval encoder index kernel latency corpus token shard query".split()
    return " ".join(" ".join(words[i] for i in rng.integers(0, len(words), 10)).capitalize()
                    + "." for _ in range(n))


def test_semantic_chunking_on_the_card_matches_the_cpu(gen, tmp_path):
    """The runner's bf16 sentence encoder on the card against the port's
    fp32 encoder of the same checkpoint on the CPU: cosine > 0.99 (the
    reference's bound between encoder forms), and the same chunks
    wherever every adjacent similarity lies farther from the threshold
    than the largest card-CPU similarity difference."""
    import numpy as np

    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.models.convert import load_model
    from arxiv_rag_tpu_torch.pipeline import runner
    from arxiv_rag_tpu_torch.pipeline.chunk import Chunker, ChunkerConfig, split_sentences
    from arxiv_rag_tpu_torch.tokenize.wordpiece import WordPieceTokenizer

    _sentence_checkpoint(tmp_path / "ckpt")
    text = _paper_text(0)
    sentences = [text[a:b] for a, b in split_sentences(text)]
    card = runner._make_sentence_encoder(_semantic_cfg(tmp_path, tmp_path / "ckpt"), "cuda")
    model, _ = load_model(tmp_path / "ckpt", compute_dtype=torch.float32, device="cpu")
    cpu = Embedder(model, WordPieceTokenizer.toy(), batch_size=512).encode_texts
    a, b = card(sentences), cpu(sentences)
    assert card.__self__.device.type == "cuda"
    assert ((a * b).sum(1)).min() > 0.99  # both L2-normalized

    def sims(e):
        return (e[:-1] * e[1:]).sum(1)

    margin = np.abs(sims(a) - sims(b)).max()
    thr = float(np.median(sims(b)))
    kw = dict(method="semantic", target_chars=900, min_chars=60, max_chars=900,
              semantic_threshold=thr)
    got = Chunker(ChunkerConfig(**kw), sentence_encoder=card).chunk(text)
    want = Chunker(ChunkerConfig(**kw), sentence_encoder=cpu).chunk(text)
    spans = split_sentences(text)
    inside = np.flatnonzero(np.abs(sims(b) - thr) <= margin)
    # every split decision before the first pair inside the margin is the
    # same on both sides, so is every chunk that ends before that pair's
    # second sentence
    end = spans[inside[0]][1] if len(inside) else len(text) + 1
    assert [(c.start, c.end) for c in got if c.end < end] == \
        [(c.start, c.end) for c in want if c.end < end]
    assert len(inside) or len(got) == len(want)
    runner._WORKER_STATE.clear()


def test_spawn_pool_on_the_card(gen, tmp_path):
    """workers=2 on the card starts its workers with spawn, each building
    its encoder on the card: the same records as the in-process run, and
    the workers' counters come back (no fallback, every sentence encoded)."""
    from pdfgen import simple_text_pdf

    from arxiv_rag_tpu_torch.logging_utils import METRICS
    from arxiv_rag_tpu_torch.pipeline import runner as rmod

    _sentence_checkpoint(tmp_path / "ckpt")
    papers = []
    for i in range(4):
        path = tmp_path / "pdfs" / f"2401.{i:05d}.pdf"
        path.parent.mkdir(parents=True, exist_ok=True)
        text = _paper_text(i, 60)
        path.write_bytes(simple_text_pdf([text[:3000], text[3000:]]))
        papers.append((f"2401.{i:05d}", str(path), "cs.IR"))
    cfg = _semantic_cfg(tmp_path, tmp_path / "ckpt")
    rows = {}
    for workers in (0, 2):
        before = dict(METRICS.snapshot()["counters"])
        run = rmod.PipelineRunner(cfg, corpus_dir=tmp_path / f"c{workers}")
        written = []

        class Mem:  # the Parquet writer needs pyarrow; keep the rows instead
            def __init__(self, d):
                pass

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def add_all(self, recs):
                written.extend(r.to_row() for r in recs)

        real, rmod.CorpusWriter = rmod.CorpusWriter, Mem
        try:
            stats = run.run(papers, max_workers=workers)
        finally:
            rmod.CorpusWriter = real
            run.close()
        after = METRICS.snapshot()["counters"]
        d = {k: after.get(k, 0.0) - before.get(k, 0.0)
             for k in ("chunk.sentences", "chunk.sentences_encoded", "chunk.semantic_fallback")}
        assert stats["ok"] == 4 and d["chunk.semantic_fallback"] == 0
        assert d["chunk.sentences"] == d["chunk.sentences_encoded"] > 0
        rows[workers] = {r["chunk_id"]: r for r in written}
    assert rows[0] == rows[2]
    rmod._WORKER_STATE.clear()

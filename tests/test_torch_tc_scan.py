"""The glue of the tensor-core scans on the CPU: the flat scan's planner,
its bf16 query rounding against JAX's, the choice of kernel by kind,
shape and mask, the operands each kind takes (flat and block table), the
3xTF32 arithmetic of the f32 kind (the split rule, and a float64 model
of the kernel against the JAX package's fp32 scan), the int8 -> bf16
widening of the row kind, and the block-table kernel's fragment-to-
(row, query) staging.

The kernels themselves run only on a card (tests/test_torch_cuda.py);
the block-table planner's division of work is held against the IVF
planners' tables in tests/test_torch_ivf.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arxiv_rag_tpu_torch.ops import fused_topk as ft


@pytest.mark.parametrize("n_rows,nq", [(2_000_000, 32), (2_000_000, 64), (2_000_000, 512),
                                       (3000, 1), (0, 8)])
def test_plan_tc_covers_rows_and_queries_in_whole_tiles(n_rows, nq):
    sm_count = 132
    split_rows, n_splits, q_tiles = ft.plan_tc(n_rows, nq, sm_count)
    assert split_rows % ft.TC_ROWS == 0 and split_rows > 0
    assert 1 <= n_splits <= 65535 and 1 <= q_tiles < 2**31
    assert split_rows * n_splits >= n_rows  # every row in some split
    assert split_rows * (n_splits - 1) < max(n_rows, 1)  # no split left empty
    assert q_tiles * ft.TC_QUERIES >= nq and (q_tiles - 1) * ft.TC_QUERIES < max(nq, 1)
    assert q_tiles * n_splits <= sm_count  # one block per SM, in one wave
    if n_rows == 2_000_000:
        assert q_tiles * n_splits > sm_count - q_tiles  # and the SMs filled


def test_tc_queries_round_as_jax_bfloat16():
    """The wrapper's bf16 queries equal ``astype(jnp.bfloat16)`` bit for
    bit: round to nearest, ties to even, on halfway cases too."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((300, 128)).astype(np.float32)
    q[0, :4] = [1 + 2.0**-8, 1 + 3 * 2.0**-8, -(1 + 2.0**-8), 2.0**-130]  # ties, subnormal
    q[1, :3] = [np.inf, -np.inf, 3.0e38]
    q[2] = rng.standard_normal(128).astype(np.float32) * 1e-3
    got = ft.tc_queries(torch.from_numpy(q))
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    want = np.asarray(jnp.asarray(q).astype(jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    # the same rounding the plain versions give the queries
    assert torch.equal(got.to(torch.float32), ft.round_queries(torch.from_numpy(q),
                                                               torch.bfloat16))


@pytest.mark.parametrize("kind,table,masked,route", [
    ("bf16", False, False, "tc"),
    ("bf16", False, True, "tc"),
    ("bf16", True, False, "tc_table"),  # the IVF block tables
    ("bf16", True, True, "tc_table"),
    ("f32", False, False, "tc"),  # 3xTF32
    ("f32", False, True, "tc"),
    ("f32", True, False, "tc_table"),
    ("s8s8", False, False, "tc"),  # int8 wgmma
    ("s8s8", False, True, "tc"),
    ("row", False, False, "tc"),  # int8 rows widened to bf16, bf16 wgmma
    ("row", False, True, "tc"),
    ("row", True, False, "tc_table"),  # an int8 IVF block table
])
def test_scan_route_by_kind_and_shape(kind, table, masked, route):
    """Every flat scan runs on ``tc_scan_kernel``, every block table on
    ``tc_table_kernel``: both on the tensor cores."""
    assert ft.scan_route(kind, table, masked) == route


class _Reached(Exception):
    """Raised in place of loading the kernels: the operands were taken."""


def _no_lib():
    raise _Reached


_F32, _BF16, _I8 = torch.float32, torch.bfloat16, torch.int8


@pytest.mark.parametrize("kind,x_dtype,q_dtype,scaled,taken", [
    ("row", _I8, _BF16, True, True),  # int8 rows, bf16 queries, row scales
    ("row", _I8, _F32, True, False),  # the queries as the CUDA-core scan read them
    ("row", _I8, _I8, True, False),  # s8s8's queries
    ("row", _I8, _BF16, False, False),  # no row scales
    ("row", _BF16, _BF16, True, False),  # a bf16 index
    ("s8s8", _I8, _I8, True, True),
    ("s8s8", _I8, _BF16, True, False),  # the row kind's queries under s8s8
    ("bf16", _BF16, _BF16, False, True),
    ("bf16", _BF16, _BF16, True, False),  # scales with a float index
    ("bf16", _I8, _BF16, False, False),
    ("f32", _F32, _F32, False, True),
    ("f32", _F32, _BF16, False, False),
])
@pytest.mark.parametrize("masked", [False, True])
def test_launch_tc_takes_each_kinds_operands_and_refuses_other_mixes(
        monkeypatch, kind, x_dtype, q_dtype, scaled, taken, masked):
    """``_launch_tc`` takes the row kind's int8 rows with bf16 queries and
    row scales, each other kind's own operands, masked or not, and
    refuses every other mix before it loads a kernel."""
    monkeypatch.setattr(ft, "_lib", _no_lib)
    x = torch.zeros((256, 64), dtype=x_dtype)
    q = torch.zeros((2, 64), dtype=q_dtype)
    q_lo = torch.zeros_like(q) if kind == "f32" else None
    scales = torch.ones(256) if scaled else None
    masks, qmask = ((torch.ones(256, dtype=torch.int32), torch.ones(2, dtype=torch.int32))
                    if masked else (None, None))
    with pytest.raises(_Reached if taken else ValueError):
        ft._launch_tc(kind, x, scales, masks, qmask, q, q_lo, None, 5, 256)


_TABLE = torch.zeros((1, 4), dtype=torch.int32)  # one tile of 2 queries at q_block 8


@pytest.mark.parametrize("kind,x_dtype,change,taken", [
    ("bf16", _BF16, {}, True),
    ("f32", _F32, {}, True),
    ("row", _I8, {}, True),
    ("bf16", _BF16, {"qb": 32}, False),  # only q_block 8 or 16
    ("bf16", _BF16, {"qb": 4}, False),
    ("s8s8", _I8, {}, False),  # an int8 table scores with the row kind
    ("bf16", _BF16, {"table": _TABLE.to(torch.int64)}, False),  # dtype
    ("bf16", _BF16, {"table": torch.zeros((2, 4), dtype=torch.int32)}, False),  # tiles
    ("bf16", _BF16, {"table": torch.zeros(4, dtype=torch.int32)}, False),  # not 2-D
    ("bf16", _BF16, {"table": torch.zeros((1, 0), dtype=torch.int32)}, False),  # no entries
    ("bf16", _BF16, {"table": torch.zeros((1, 4), dtype=torch.int32, device="meta")},
     False),  # another device
    ("bf16", _BF16, {"d": 100}, False),  # D % 64 != 0
    ("row", _I8, {"d": 96}, False),
    ("bf16", _BF16, {"block_rows": 0}, False),
])
def test_launch_table_refuses_what_the_kernel_cannot_take(monkeypatch, kind, x_dtype, change,
                                                          taken):
    """``_launch_table`` takes each table kind's operands and refuses,
    before it loads a kernel, a q_block other than 8 or 16, the s8s8
    kind, a table of the wrong dtype, shape or device, a D the kernel
    cannot take and an empty block."""
    monkeypatch.setattr(ft, "_lib", _no_lib)
    d = change.get("d", 64)
    x = torch.zeros((256, d), dtype=x_dtype)
    q = torch.zeros((2, d), dtype=_F32 if kind == "f32" else _I8 if kind == "s8s8" else _BF16)
    q_lo = torch.zeros_like(q) if kind == "f32" else None
    scales = torch.ones(256) if x_dtype == _I8 else None
    with pytest.raises(_Reached if taken else ValueError):
        ft._launch_table(kind, change.get("qb", 8), x, scales, None, None, q, q_lo,
                         change.get("table", _TABLE), 5, 256, change.get("block_rows", 128))


@pytest.mark.parametrize("qb", ft.Q_BLOCKS)
def test_table_fragment_staging_reads_each_row_query_pair_once(qb):
    """A numpy model of the block-table kernel's epilogue: the m64nN
    accumulator fragment (lane (g, t4) of warp wi holds, of half h,
    register 4i + 2j + c = row 64h + 16wi + g + 8j, query 8i + 2t4 + c)
    staged at ``query * kTbStride + row``, then read by warp q % 4, lane
    l taking rows l + 32m: every (row, query) pair of the 128-row slice
    is written once and read once, by the warp that owns the query, and
    each store instruction's 32 lanes hit 32 different banks."""
    stride = ft.TABLE_ROWS + 4  # kTbStride
    written = {}
    for wi in range(4):
        for h in range(2):
            for i in range(qb // 8):
                for j in range(2):
                    for c in range(2):
                        banks = set()
                        for lane in range(32):
                            g, t4 = lane >> 2, lane & 3
                            row, q = 64 * h + 16 * wi + g + 8 * j, 8 * i + 2 * t4 + c
                            addr = q * stride + row
                            assert addr not in written
                            written[addr] = (row, q)
                            banks.add(addr % 32)
                        assert len(banks) == 32  # one store, no bank conflict
    assert sorted(written.values()) == [(r, q) for r in range(128) for q in range(qb)]
    read = []
    for wi in range(4):
        for q in range(wi, qb, 4):  # the warp's queries
            for lane in range(32):
                for m in range(4):
                    read.append(written[q * stride + lane + 32 * m])
                    assert read[-1][1] == q
    assert sorted(read) == sorted(written.values())  # each pair read once


def test_row_table_a_fragments_pair_each_column_once():
    """A numpy model of the row kind's A operand from registers
    (``tb_widen_a``): lane (g, t4) reads 16 int8 bytes at 16·t4 of a row
    and, per k-step kk, hands byte 4kk + j to wgmma as logical column
    16kk + 2t4 + (j & 1) + 8(j >> 1) (the m64nNk16 A fragment's columns);
    ``table_row_queries`` puts at each logical column the query value of
    the physical column that lands there. Summed over the fragments, the
    dot product of every row with every query is its plain one, each
    physical column once; and the permutation is what JAX's bf16
    rounding of the queries gives, reordered."""
    rng = np.random.default_rng(21)
    d = 192
    rows = rng.integers(-127, 128, (2, d)).astype(np.int64)
    q = rng.standard_normal((3, d)).astype(np.float32)
    qb = ft.tc_queries(torch.from_numpy(q))
    qp = ft.table_row_queries(qb).to(torch.float32).numpy().astype(np.float64)
    want = rows.astype(np.float64) @ qb.to(torch.float32).numpy().astype(np.float64).T
    got = np.zeros_like(want)
    for s in range(d // 64):
        used = []
        for t4 in range(4):
            for kk in range(4):
                for j in range(4):
                    phys = 64 * s + 16 * t4 + 4 * kk + j
                    logical = 64 * s + 16 * kk + 2 * t4 + (j & 1) + 8 * (j >> 1)
                    got += rows[:, phys, None] * qp[None, :, logical]
                    used.append(logical)
        assert sorted(used) == list(range(64 * s, 64 * s + 64))
    np.testing.assert_array_equal(got, want)  # exact: int8 x bf16 products in float64
    jq = np.asarray(jnp.asarray(q).astype(jnp.bfloat16)).astype(np.float32)
    np.testing.assert_array_equal(np.sort(qp, axis=1), np.sort(jq, axis=1).astype(np.float64))


# -- the 3xTF32 split of the f32 scan ------------------------------------------


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


def test_tf32_split_leaves_low_bits_zero_and_sums_to_q():
    """Both halves carry zeros in the 13 mantissa bits TF32 drops, and
    head + tail is q within 2^-21·|q| elementwise (the rule gives
    2^-22); a tie at half a TF32 step rounds away from zero."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((64, 768)).astype(np.float32)
    q[1] *= 1e-6
    q[2] *= 1e6
    q[3, :4] = [1 + 2.0**-11, -(1 + 2.0**-11), 1 + 3 * 2.0**-11, 0.0]  # ties, zero
    head, tail = ft.tf32_split(torch.from_numpy(q))
    assert head.dtype == tail.dtype == torch.float32
    assert head.is_contiguous() and tail.is_contiguous()
    assert not (_bits(head) & 0x1FFF).any() and not (_bits(tail) & 0x1FFF).any()
    q64 = q.astype(np.float64)
    err = np.abs(head.numpy().astype(np.float64) + tail.numpy().astype(np.float64) - q64)
    assert (err <= 2.0**-21 * np.abs(q64)).all()
    np.testing.assert_array_equal(head.numpy()[3, :4], [1 + 2.0**-10, -(1 + 2.0**-10),
                                                        1 + 4 * 2.0**-11, 0.0])
    assert (tail.numpy()[3, :4] == [-(2.0**-11), 2.0**-11, -(2.0**-11), 0.0]).all()


def _model_scan(x: np.ndarray, q: np.ndarray, k: int, passes: int = 3):
    """The f32 tensor-core scan's arithmetic in float64: rows and queries
    split by the kernel's rule, q_lo·x_hi + q_hi·x_lo + q_hi·x_hi (passes
    = 3) or q_hi·x_hi alone (passes = 1, a single TF32 pass), the fp32
    score, top-k in the kernels' order."""
    xh, xl = (t.numpy().astype(np.float64) for t in ft.tf32_split(torch.from_numpy(x)))
    qh, ql = (t.numpy().astype(np.float64) for t in ft.tf32_split(torch.from_numpy(q)))
    s = qh @ xh.T
    if passes == 3:
        s = ql @ xh.T + qh @ xl.T + s
    return ft.kernel_order(torch.from_numpy(s.astype(np.float32)), k)


def _jax_f32_topk(x: np.ndarray, q: np.ndarray, k: int):
    from arxiv_rag_tpu.ops.pallas_topk import fused_topk as jax_fused_topk

    jv, ji = jax_fused_topk(jnp.asarray(x), jnp.asarray(q), k, block_rows=512, interpret=True)
    return np.asarray(jv), np.asarray(ji)


def _unit_rows(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _agrees(v, i, jv, ji, tol=1e-4) -> bool:
    from arxiv_rag_tpu_torch.ops.topk import recall_at_k

    v, i = v.numpy(), i.numpy()
    return (np.abs(v - jv).max() <= tol
            and recall_at_k(i, ji, jv, tie_tol=tol, candidate_scores=v) == 1.0)


def test_tf32x3_model_matches_jax_f32_scan():
    """The kernel's 3xTF32 arithmetic, modelled in float64, gives the JAX
    package's fp32 (Precision.HIGHEST) scan within 1e-4 with tie-tolerant
    recall 1.0."""
    rng = np.random.default_rng(12)
    x, q = _unit_rows(rng, 2000, 256), _unit_rows(rng, 24, 256)
    q[0] = x[17]
    jv, ji = _jax_f32_topk(x, q, 10)
    v, i = _model_scan(x, q, 10)
    assert _agrees(v, i, jv, ji)
    assert np.abs(v.numpy() - jv).max() <= 1e-5  # the dropped q_lo·x_lo term is ~2^-21


def _low_bits_0fff(a: np.ndarray) -> np.ndarray:
    """Every f32 value's low 13 bits set to 0x0fff: just under half a TF32
    step, so rounding and truncation both drop ~2^-11 of each value, all
    toward zero."""
    b = a.view(np.uint32)
    return ((b & np.uint32(0xFFFFE000)) | np.uint32(0x0FFF)).view(np.float32)


def test_crafted_low_bits_case_is_sharp():
    """Unit rows and queries whose values all have low bits 0x0fff, one
    query a copy of a row: a single TF32 pass misses 1e-4 (~1e-3 at the
    score near 1), the 3xTF32 model holds it against JAX."""
    rng = np.random.default_rng(13)
    x = _low_bits_0fff(_unit_rows(rng, 1500, 256))
    q = _low_bits_0fff(_unit_rows(rng, 16, 256))
    q[0] = x[42]
    jv, ji = _jax_f32_topk(x, q, 10)
    assert ji[0, 0] == 42 and abs(jv[0, 0] - 1.0) < 1e-3
    v3, i3 = _model_scan(x, q, 10)
    assert _agrees(v3, i3, jv, ji)
    v1, _ = _model_scan(x, q, 10, passes=1)
    assert abs(v1.numpy()[0, 0] - jv[0, 0]) > 5e-4
    assert not np.abs(v1.numpy() - jv).max() <= 1e-4


def test_tc_variants_still_apply_to_the_kernel_source():
    """``tc_variants.py`` makes its variants by editing the text of
    ``csrc/fused_topk.cu``: each edit finds its line and changes it."""
    from arxiv_rag_tpu_torch import tc_variants
    from arxiv_rag_tpu_torch.ops import _build

    src = (_build.CSRC / "fused_topk.cu").read_text()
    made = tc_variants.variants(src)
    assert made["as_is"] == src
    assert len(set(made.values())) == len(made)  # every variant differs from the rest


def test_tb_variants_still_apply_to_the_kernel_source():
    """``tb_variants.py`` makes its variants of the block-table kernel by
    editing the text of ``csrc/fused_topk.cu``: each edit finds its line
    and changes it."""
    from arxiv_rag_tpu_torch import tb_variants
    from arxiv_rag_tpu_torch.ops import _build

    src = (_build.CSRC / "fused_topk.cu").read_text()
    made = tb_variants.variants(src)
    assert made["as_is"] == src
    assert len(set(made.values())) == len(made)  # every variant differs from the rest


# -- the int8 -> bf16 widening of the row kind ---------------------------------


def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays: byte n of the
    result is byte (nibble n of ``sel``) of the 8 bytes {y:x}."""
    out = np.zeros_like(x)
    for n in range(4):
        src = (sel >> (4 * n)) & 7
        word = x if src < 4 else y
        out |= ((word >> np.uint32(8 * (src & 3))) & np.uint32(0xFF)) << np.uint32(8 * n)
    return out


def _widen4_model(w: np.ndarray) -> np.ndarray:
    """``csrc/fused_topk.cu::widen4`` step for step: four int8 values in a
    word (little-endian) to four bf16 values in two words."""
    u = w ^ np.uint32(0x80808080)
    magic = np.full_like(u, 0x4B000000)
    f = [(_byte_perm(u, magic, 0x7540 + b).view(np.float32) - np.float32(8388736.0))
         .astype(np.float32).view(np.uint32) for b in range(4)]
    return np.stack([_byte_perm(f[0], f[1], 0x7632), _byte_perm(f[2], f[3], 0x7632)], axis=-1)


def test_row_widening_is_exact_for_every_int8_value():
    """The kernel's byte-permute widening gives every int8 value's bf16
    bits, in memory order, as ``int8.to(bfloat16)`` does."""
    vals = np.arange(-128, 128, dtype=np.int8)
    words = np.ascontiguousarray(vals).view(np.uint32)  # 4 values per word
    got = _widen4_model(words).reshape(-1).view(np.uint16)
    want = torch.from_numpy(vals).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)

"""Fused top-k scans: the CUDA kernels K1–K6's scans and their plain versions.

The port of ``arxiv_rag_tpu/ops/pallas_topk.py``: ``fused_topk`` :810
(K1), ``fused_topk_int8`` :928 with its s8s8 default (K2) and its "row"
variant (K3), and the masked forms ``fused_topk_masked`` :864 and
``fused_topk_int8_masked`` :1011 (K4); and the block-table scan of
``arxiv_rag_tpu/ops/pallas_ivf.py`` (K5, K6), launched by ``ops/ivf.py``
through ``scan_table``. The kernels are in ``csrc/fused_topk.cu``; their
design and bound are noted there. ``scan_route`` chooses the kernel by
kind, shape and mask alone, with no fallback; both run on the tensor
cores (wgmma fed by TMA):

- ``tc_scan_kernel``: every flat scan, masked (K4) or not, of an f32
  (K1 f32, as 3×TF32: three TF32 products per term, fp32-accurate,
  never a single TF32 pass), bf16 (K1 bf16) or int8 index, s8s8 (K2,
  int8 wgmma) or "row" (K3: the int8 rows widened to bf16 in shared
  memory, then bf16 wgmma). At the serving shapes K1 bf16, K1 f32 and
  K3 are bound by their products at large Q and by reading the index at
  small Q; K2 by reading the index.
- ``tc_table_kernel``: every block table (K5, K6), f32, bf16 or row,
  masked or not: the rows on wgmma's M, the tile's 8 or 16 queries on
  its N. Bound by the bytes of its visits' rows; ``plan_table`` spreads
  each tile's (visit, 128-row slice) items over enough splits to fill
  the card.

Contract, shared with the TPU kernels: values [Q,k] fp32 and ids [Q,k]
int32, k ≤ 128; scores ordered descending with the lowest row id first
among equal scores; rows with id ≥ ``n_valid`` never appear; slots that
no row fills hold (-inf, -1).

- ``fused_topk``: an f32 or bf16 index; queries rounded to the index
  dtype; fp32 accumulation (fp32-accurate products for an f32 index:
  the plain version's fp32 matmul, the kernel's 3×TF32, within 1e-4).
- ``fused_topk_int8`` s8s8: queries quantized per row to int8 (scale
  max(max|q|, 1e-8)·float32(1/127), round half to even, clip ±127, as
  ``pallas_topk.py:904-908`` compiles); exact s32 products; ranked by
  ``float(acc) * row_scale``; the k survivors times the query scale.
- ``fused_topk_int8`` "row": queries rounded to bf16, the exact int8 ×
  bf16 products summed in fp32, times the row scale.
- masked forms: a row counts for a query only where
  ``row_mask & query_mask != 0`` (int32 views of the uint32 category
  bits); row validity is folded in (rows ≥ n_valid never count).

``merge_topk`` merges candidate lists that other launches produced (the
shards of ``parallel/``) with the scans' own k-way merge kernel, in the
same order and with no query scale.

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes
the plain version for a CPU tensor. ``LAUNCHES`` counts kernel launches,
by kernel: a block-table scan of an int8 index counts as a K3 launch too,
since it scores with the row variant; ``topk_merge`` counts only the
merges ``merge_topk`` launches (each scan's own merge is part of its
launch).
"""

from __future__ import annotations

import ctypes

import torch

from arxiv_rag_tpu_torch.ops import _build
from arxiv_rag_tpu_torch.ops.topk import NEG_INF, topk_padded

K_MAX = 128
TC_QUERIES = 64  # queries per tensor-core scan block (kTcQ, the wgmma M)
TC_ROWS = 128  # rows per tensor-core scan tile (kTcRows, the wgmma N)
TABLE_ROWS = 128  # rows per block-table work item (kTbRows: two m64 products)
Q_BLOCKS = (8, 16)  # the block-table scan's query tiles (template QB, the wgmma N)
TABLE_SPLIT_ITEMS = 64  # items a block-table split aims at, past one wave (plan_table)
_KIND = {"f32": 0, "bf16": 1, "s8s8": 2, "row": 3}
_PLAIN_SCORE_ELEMS = 1 << 26  # plain versions score this many [q, row] pairs at a time

LAUNCHES = _build.Launches("fused_topk", "fused_topk_int8", "fused_topk_int8_row",
                           "fused_topk_masked", "ivf_topk", "ivf_topk_device", "topk_merge")
reset_launches = LAUNCHES.reset
count = LAUNCHES.count
_p, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_lib = _build.Library("fused_topk", {
    "arag_topk_merge": ([_p, _p, _i32, _i32, _i32, _p, _p, _p, _p], _i32),
    "arag_topk_table_scan": ([_i32, _i32, _p, _p, _p, _p, _p, _p, _i64, _i32, _i32, _i32, _p,
                              _i32, _i32, _i32, _p, _p, _p], _i32),
    "arag_topk_table_smem": ([_i32, _i32, _i32], ctypes.c_size_t),
    "arag_topk_table_blocks": ([_i32, _i32, _i32], _i32),
    "arag_topk_tc_scan": ([_i32, _p, _p, _p, _p, _p, _p, _i64, _i32, _i32, _i32, _i32, _i32,
                           _p, _p, _p], _i32),
    "arag_topk_tc_smem": ([_i32, _i32, _i32], ctypes.c_size_t),
    "arag_topk_tc_lists": ([_i32], _i32),
})
# (library handle, kind, q_block, list capacity, device) -> (SMs, blocks an SM)
_TABLE_FIT: dict[tuple, tuple[int, int]] = {}


def _check_k(k: int) -> None:
    if not 1 <= k <= K_MAX:
        raise ValueError(
            f"fused top-k holds 1..{K_MAX} candidates per query (got k={k}); "
            "use ops.topk.flat_search for larger k"
        )


def _n_valid(n_rows: int, n_valid: int | None) -> int:
    n = n_rows if n_valid is None else int(n_valid)
    if not 0 <= n <= n_rows:
        raise ValueError(f"n_valid {n} outside [0, {n_rows}]")
    return n


def _check_variant(variant: str) -> None:
    if variant not in ("s8s8", "row"):
        raise ValueError(f"int8 variant must be 's8s8' or 'row', not {variant!r}")


def quantize_queries(queries: torch.Tensor,
                     query_scale: str = "product") -> tuple[torch.Tensor, torch.Tensor]:
    """s8s8 query quantization: (int8 [Q,D], fp32 scales [Q]). The scale is
    max(max|q|, 1e-8) times float32(1/127) ("product"): inside its
    single-device jit the reference's ``/ 127.0`` compiles to that
    product. Inside ``shard_map`` (its sharded route,
    ``parallel/search.py:100-101``) the same expression stays a quotient
    ("quotient", divided by a tensor so that the card divides too); the
    two differ in the last bit for some rows."""
    if query_scale not in ("product", "quotient"):
        raise ValueError(f"query_scale must be 'product' or 'quotient', not {query_scale!r}")
    qf = queries.to(torch.float32)
    amax = torch.clamp(torch.amax(torch.abs(qf), dim=1, keepdim=True), min=1e-8)
    if query_scale == "product":
        qs = amax * torch.tensor(1.0 / 127.0, dtype=torch.float32, device=qf.device)
    else:
        qs = amax / torch.tensor(127.0, dtype=torch.float32, device=qf.device)
    q8 = torch.clamp(torch.round(qf / qs), -127, 127).to(torch.int8)
    return q8, qs[:, 0]


def round_queries(queries: torch.Tensor, index_dtype: torch.dtype) -> torch.Tensor:
    """fp32 queries as a scan of an ``index_dtype`` index sees them: f32 as
    they are, rounded to bf16 for a bf16 or int8 ("row") index."""
    q = queries.to(torch.float32)
    if index_dtype == torch.float32:
        return q
    return q.to(torch.bfloat16).to(torch.float32)


# -- plain versions ------------------------------------------------------------


def kernel_order(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k in the kernels' order; -inf entries are empty slots (-inf, -1)."""
    vals, ids = topk_padded(scores, k)
    ids = torch.where(vals == NEG_INF, torch.full_like(ids, -1), ids)
    return vals, ids.to(torch.int32)


def _eligible(row_masks: torch.Tensor, query_mask: torch.Tensor) -> torch.Tensor:
    """[q, n] bool: ``row_mask & query_mask != 0`` on the int32 bits."""
    return (row_masks.to(torch.int32)[None, :] & query_mask.to(torch.int32)[:, None]) != 0


def _exact_int8_scores(q8: torch.Tensor, x8: torch.Tensor) -> torch.Tensor:
    """fp32 ``q8·x8ᵀ`` of int8 operands, each sum exact and rounded once,
    as the s32 sum of the kernels and the reference converted to fp32:
    the products summed in float64 (exact below 2⁵³, where an fp32 sum
    stops being exact past 2²⁴), a bounded number of rows converted at a
    time."""
    out = torch.empty((q8.shape[0], x8.shape[0]), dtype=torch.float32, device=x8.device)
    qd = q8.to(torch.float64)
    rows = max(1, _PLAIN_SCORE_ELEMS // max(1, x8.shape[1]))
    for r in range(0, x8.shape[0], rows):
        out[:, r : r + rows] = qd @ x8[r : r + rows].to(torch.float64).T
    return out


def score_plain(x: torch.Tensor, q: torch.Tensor, k: int, *, scales=None,
                row_masks=None, query_mask=None, qscale=None):
    """The scans' function in plain PyTorch over every row of ``x``: fp32
    scores ``q·xᵀ`` of fp32 operands, or for int8 ``x`` and ``q`` (s8s8)
    the exact integer sums rounded once to fp32; × the row scale (one
    rounded product), filtered rows at -inf, top-k in the kernels' order,
    then the survivors × ``qscale``. Scores a bounded number of pairs at
    a time."""
    step = max(1, _PLAIN_SCORE_ELEMS // max(1, x.shape[0]))
    vals, ids = [], []
    for s in range(0, q.shape[0], step):
        if x.dtype == torch.int8:
            scores = _exact_int8_scores(q[s : s + step], x)
        else:
            scores = q[s : s + step] @ x.T
        if scales is not None:
            scores = scores * scales[None, :]
        if row_masks is not None:
            keep = _eligible(row_masks, query_mask[s : s + step])
            scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
        v, i = kernel_order(scores, k)
        if qscale is not None:
            v = v * qscale[s : s + step, None]
        vals.append(v)
        ids.append(i)
    if not vals:
        return _empty(k, x.device)
    return torch.cat(vals), torch.cat(ids)


def _flat_plain(values, queries, k, n_valid, *, kind, scales=None, row_masks=None,
                query_mask=None, query_scale="product"):
    """Any flat scan kind in plain PyTorch over rows [0, n_valid)."""
    _check_k(k)
    n = _n_valid(values.shape[0], n_valid)
    x = values[:n] if kind == "s8s8" else values[:n].to(torch.float32)
    qscale = None
    if kind == "s8s8":
        q, qscale = quantize_queries(queries, query_scale)
    else:
        q = round_queries(queries, torch.float32 if kind == "f32" else torch.bfloat16)
    return score_plain(
        x, q, k,
        scales=None if scales is None else scales[:n].to(torch.float32),
        row_masks=None if row_masks is None else row_masks[:n],
        query_mask=query_mask, qscale=qscale,
    )


def _float_kind(dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.bfloat16:
        return "bf16"
    raise ValueError(f"this scan takes an f32 or bf16 index, not {dtype}")


def fused_topk_plain(index, queries, k, *, n_valid=None):
    """K1's function in plain PyTorch: fp32 scores (queries rounded to the
    index dtype first), rows ≥ n_valid at -inf, stable top-k."""
    return _flat_plain(index, queries, k, n_valid, kind=_float_kind(index.dtype))


def fused_topk_int8_plain(values, scales, queries, k, *, n_valid=None, variant="s8s8",
                          query_scale="product"):
    """K2's (s8s8) or K3's ("row") function in plain PyTorch. s8s8: the
    exact integer sum of the int8 products (at any D) rounded once to
    fp32, times the row scale, ranked, then the survivors times the
    query scale (``quantize_queries``). row: bf16 queries, fp32 sums, ×
    row scale."""
    _check_variant(variant)
    return _flat_plain(values, queries, k, n_valid, kind=variant, scales=scales,
                       query_scale=query_scale)


def fused_topk_masked_plain(index, row_masks, query_mask, queries, k, *, n_valid=None):
    """K4 (f32/bf16) in plain PyTorch: K1's scores, ineligible rows -inf."""
    return _flat_plain(index, queries, k, n_valid, kind=_float_kind(index.dtype),
                       row_masks=row_masks, query_mask=query_mask)


def fused_topk_int8_masked_plain(values, scales, row_masks, query_mask, queries, k, *,
                                 n_valid=None, variant="s8s8", query_scale="product"):
    """K4 (int8) in plain PyTorch: K2's or K3's scores, ineligible rows
    -inf (the s8s8 query scale keeps them -inf)."""
    _check_variant(variant)
    return _flat_plain(values, queries, k, n_valid, kind=variant, scales=scales,
                       row_masks=row_masks, query_mask=query_mask, query_scale=query_scale)


def _empty(k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty((0, k), dtype=torch.float32, device=device),
            torch.empty((0, k), dtype=torch.int32, device=device))


# -- CUDA kernels --------------------------------------------------------------


def plan_tc(n_rows: int, nq: int, sm_count: int) -> tuple[int, int, int]:
    """(rows per split, splits, query tiles) of the tensor-core scan: one
    block per SM (its shared memory holds one), the query tiles of a split
    side by side in the grid so that they stream the same rows at once and
    share them in L2; splits a whole number of 128-row tiles."""
    q_tiles = -(-nq // TC_QUERIES)
    tiles = max(1, -(-n_rows // TC_ROWS))
    n_splits = min(tiles, 65535, max(1, sm_count // q_tiles))
    per_split = -(-tiles // n_splits)
    return per_split * TC_ROWS, -(-tiles // per_split), q_tiles


def scan_route(kind: str, table: bool, masked: bool) -> str:
    """The kernel a scan launches: ``"tc"`` (``tc_scan_kernel``) for every
    flat scan, of any kind (f32, bf16, s8s8, row), masked or not;
    ``"tc_table"`` (``tc_table_kernel``) for every block table."""
    return "tc_table" if table else "tc"


def tc_queries(queries: torch.Tensor) -> torch.Tensor:
    """The bf16 queries the tensor-core scan reads for a bf16 or an int8
    row index: fp32, then rounded to the nearest bf16 (ties to even), as
    ``round_queries`` rounds them."""
    return queries.to(torch.float32).to(torch.bfloat16).contiguous()


def table_row_queries(q: torch.Tensor) -> torch.Tensor:
    """The bf16 queries of a row-kind block-table scan, each 64-column
    group's columns reordered as the kernel takes its rows' int8 bytes
    (``csrc/fused_topk.cu::tb_widen_a``): logical column 16kk + 8hi +
    2t4 + lo holds physical column 16t4 + 4kk + 2hi + lo, so each lane
    reads 16 contiguous bytes of a row for its four k-steps. A reshape,
    no index tensor: a permutation of the terms of every dot product."""
    n, d = q.shape
    if d % 64:
        return q  # refused by the wrapper's checks
    return q.reshape(n, d // 64, 4, 4, 2, 2).permute(0, 1, 3, 4, 2, 5).reshape(n, d).contiguous()


def _tf32_head(v: torch.Tensor) -> torch.Tensor:
    """``v`` (fp32) rounded to the nearest TF32 value, a tie away from
    zero: half a TF32 step added to the bits, the low 13 bits cleared
    (``csrc/fused_topk.cu::tf32_head``, bit for bit)."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3×TF32 split of fp32 queries: (head, tail), both contiguous
    fp32 with their low 13 bits zero; head = the nearest TF32 value,
    tail = the same rounding of ``q - head`` (exact in fp32), so
    ``head + tail`` is ``q`` within 2⁻²²·|q|. The kernel splits the rows
    by the same rule."""
    q = queries.to(torch.float32).contiguous()
    head = _tf32_head(q)
    return head, _tf32_head(q - head).contiguous()


def plan_table(width: int, tiles: int, per_visit: int, sm_count: int,
               blocks_per_sm: int) -> int:
    """Splits of each tile's block-table work, from shapes alone (the
    table's contents stay on the device): at least one wave of blocks
    over the card, more where a table row's ``width × per_visit`` items
    (its width bounds its real visits) would give a split more than
    ``TABLE_SPLIT_ITEMS``, so that the block scheduler evens out tiles
    of unequal work; never more splits than items."""
    items = max(1, width * per_visit)
    fill = -(-max(1, sm_count * blocks_per_sm) // max(1, tiles))
    return max(1, min(items, 65535, max(fill, -(-items // TABLE_SPLIT_ITEMS))))


def _check_cuda(x: torch.Tensor, q: torch.Tensor) -> None:
    if x.dim() != 2 or q.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"index {tuple(x.shape)} and queries {tuple(q.shape)} "
                         "must be [N, D] and [Q, D]")
    if q.device != x.device:
        raise ValueError(f"queries on {q.device}, index on {x.device}")
    if x.shape[1] % 64:
        raise ValueError(f"the CUDA scan needs D % 64 == 0 (got D={x.shape[1]})")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the index must be contiguous and 16-byte aligned")
    if x.shape[0] >= 2**31:
        raise ValueError("the CUDA scan takes fewer than 2^31 rows")


def _check_side(t: torch.Tensor | None, name: str, x: torch.Tensor, dtype) -> None:
    if t is not None and (t.dtype != dtype or t.shape != (x.shape[0],)
                          or t.device != x.device or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous {dtype} [N] on the index's device")


def _check_qmask(query_mask: torch.Tensor, q: torch.Tensor) -> None:
    if (query_mask.dtype != torch.int32 or query_mask.shape != (q.shape[0],)
            or query_mask.device != q.device):
        raise ValueError("query_mask must be int32 [Q] on the queries' device")


# kind -> (index dtype, query dtype) of the tensor-core scan
_TC_DTYPES = {"f32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
              "s8s8": (torch.int8, torch.int8), "row": (torch.int8, torch.bfloat16)}


def _check_tc_operands(kind, x, scales, row_masks, qmask, q, q_lo) -> None:
    """The operands a tensor-core scan of ``kind`` takes: its index and
    query dtypes (``_TC_DTYPES``), row scales with an int8 index only,
    query tails for f32 only."""
    _check_operands(x, q, scales, row_masks, qmask)
    x_dtype, q_dtype = _TC_DTYPES[kind]
    if x.dtype != x_dtype or q.dtype != q_dtype:
        raise ValueError(f"a {kind} scan takes a {x_dtype} index and {q_dtype} queries, "
                         f"not {x.dtype} and {q.dtype}")
    if (scales is not None) != (x_dtype == torch.int8):
        raise ValueError("row scales go with the int8 scans (s8s8, row), and only with them")
    if (q_lo is not None) != (kind == "f32") or q_lo is not None and (
            q_lo.shape != q.shape or q_lo.dtype != q.dtype or q_lo.device != q.device
            or not q_lo.is_contiguous()):
        raise ValueError("an f32 scan takes query tails shaped as the heads; no other does")


def _launch_tc(kind, x, scales, row_masks, qmask, q, q_lo, qscale, k, n_valid):
    """A flat scan on the tensor cores, masked or not, then the merge of
    its [splits × lists, Q, k] candidates (× the s8s8 query scale).
    Queries ``q`` as the kind reads them: bf16 (bf16 and row); int8
    (s8s8); the TF32 heads for f32, with ``q_lo`` their tails."""
    _check_tc_operands(kind, x, scales, row_masks, qmask, q, q_lo)
    lib = _lib()
    dev = x.device
    d = x.shape[1]
    nq = q.shape[0]
    props = _check_smem(lib.arag_topk_tc_smem(_KIND[kind], k, d), dev, d)
    split_rows, n_splits, _ = plan_tc(n_valid, nq, props.multi_processor_count)
    cand_v, cand_i = _scratch(n_splits * lib.arag_topk_tc_lists(k), nq, k, dev)
    with _build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.arag_topk_tc_scan(
            _KIND[kind],
            x.data_ptr() if x.shape[0] else q.data_ptr(),  # an empty index loads nothing
            _ptr(scales), _ptr(row_masks), _ptr(qmask if row_masks is not None else None),
            q.data_ptr(), _ptr(q_lo), n_valid, d, nq, k, split_rows // TC_ROWS, n_splits,
            cand_v.data_ptr(), cand_i.data_ptr(), stream,
        )
        _lib.check(err, "tensor-core top-k scan")
        return _merge(lib, cand_v, cand_i, qscale, stream)


def _launch_table(kind, qb, x, scales, row_masks, qmask, q, q_lo, table, k, n_valid,
                  block_rows):
    """A block-table scan on the tensor cores (tile t of ``qb`` queries
    scans the blocks listed in ``table[t]``, int32 [tiles, width]), then
    the merge of its [splits, Q, k] candidates. Queries ``q`` as the kind
    reads them: bf16 (bf16 and row); the TF32 heads for f32, with
    ``q_lo`` their tails."""
    if qb not in Q_BLOCKS:
        raise ValueError(f"the block-table scan takes q_block 8 or 16, not {qb}")
    if kind == "s8s8":
        raise ValueError("the block-table scan scores an int8 index with the row kind, "
                         "never s8s8 (as the reference's IVF scan)")
    _check_tc_operands(kind, x, scales, row_masks, qmask, q, q_lo)
    dev = x.device
    nq = q.shape[0]
    tiles = -(-nq // qb)
    if (table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != tiles
            or table.shape[1] < 1 or table.device != dev or not table.is_contiguous()):
        raise ValueError(f"block table must be contiguous int32 [{tiles}, width >= 1] on "
                         f"{dev}, got {table.dtype} {tuple(table.shape)} on {table.device}")
    if not 1 <= block_rows < 2**31:
        raise ValueError(f"block_rows must be positive, not {block_rows}")
    lib = _lib()
    d = x.shape[1]
    with _build.on_device(dev):
        sm_count, blocks = _table_fit(lib, _KIND[kind], qb, k, dev)
        width = table.shape[1]
        n_splits = plan_table(width, tiles, -(-block_rows // TABLE_ROWS), sm_count, blocks)
        cand_v, cand_i = _scratch(n_splits, nq, k, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.arag_topk_table_scan(
            _KIND[kind], qb, x.data_ptr(), _ptr(scales), _ptr(row_masks),
            _ptr(qmask if row_masks is not None else None), q.data_ptr(), _ptr(q_lo),
            n_valid, d, nq, k, table.data_ptr(), width, block_rows, n_splits,
            cand_v.data_ptr(), cand_i.data_ptr(), stream,
        )
        _lib.check(err, "block-table scan")
        return _merge(lib, cand_v, cand_i, None, stream)


def _table_fit(lib, kind: int, qb: int, k: int, dev) -> tuple[int, int]:
    """(SMs, table-scan blocks an SM holds) on ``dev`` (the current
    device) for the instantiation that runs ``k``: asked of the card once
    per library, instantiation and device (the shared memory checked
    against its limit, the occupancy calculator), then kept."""
    key = (lib._handle, kind, qb, 16 if k <= 16 else K_MAX, dev)
    if key not in _TABLE_FIT:
        props = _check_smem(lib.arag_topk_table_smem(kind, qb, k), dev, None)
        blocks = lib.arag_topk_table_blocks(kind, qb, k)
        if blocks < 1:
            _lib.check(-blocks, "block-table scan (occupancy)")
            raise ValueError("a block-table scan block fits no SM")
        _TABLE_FIT[key] = (props.multi_processor_count, blocks)
    return _TABLE_FIT[key]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_operands(x, q, scales, row_masks, qmask) -> None:
    _check_cuda(x, q)
    _check_side(scales, "scales", x, torch.float32)
    _check_side(row_masks, "row_masks", x, torch.int32)
    if row_masks is not None:
        _check_qmask(qmask, q)


def _check_smem(smem: int, dev, d: int | None):
    """The card's properties, after checking that a block of ``smem``
    bytes of shared memory fits (``d``: the D it was sized for, if it
    depends on D)."""
    props = torch.cuda.get_device_properties(dev)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    if smem > limit:
        at = "" if d is None else f"D={d} "
        raise ValueError(f"{at}needs {smem} bytes of shared memory per block; "
                         f"the card allows {limit}")
    return props


def _scratch(n_lists: int, nq: int, k: int, dev):
    return (torch.empty((n_lists, nq, k), dtype=torch.float32, device=dev),
            torch.empty((n_lists, nq, k), dtype=torch.int32, device=dev))


def _merge(lib, cand_v, cand_i, qscale, stream):
    """k-way merge of the [lists, Q, k] candidates (× the query scale)."""
    n_lists, nq, k = cand_v.shape
    out_v = torch.empty((nq, k), dtype=torch.float32, device=cand_v.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=cand_v.device)
    err = lib.arag_topk_merge(
        cand_v.data_ptr(), cand_i.data_ptr(), n_lists, nq, k, _ptr(qscale),
        out_v.data_ptr(), out_i.data_ptr(), stream,
    )
    _lib.check(err, "fused top-k merge")
    return out_v, out_i


def merge_topk_plain(cand_v: torch.Tensor, cand_i: torch.Tensor):
    """``merge_topk``'s function in plain PyTorch: each query's lists
    side by side ([Q, L·k], in list order), then a stable descending sort:
    among equal scores the earlier entry wins, as ``lax.top_k`` over the
    reference's shard-ordered candidates; empty slots (-inf, -1)."""
    n_lists, nq, k = cand_v.shape
    v = cand_v.permute(1, 0, 2).reshape(nq, n_lists * k)
    i = cand_i.permute(1, 0, 2).reshape(nq, n_lists * k)
    vals, pos = topk_padded(v, k)
    ids = torch.gather(i, 1, pos.clamp(min=0)).to(torch.int32)
    return vals, torch.where(vals == NEG_INF, torch.full_like(ids, -1), ids)


def merge_topk(cand_v: torch.Tensor, cand_i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Lossless merge of L candidate lists per query (fp32 values and int32
    ids, [L, Q, k]), each in the scans' order (score descending, then id
    ascending), into one [Q, k] list. Where list l's ids all lie below
    list l+1's (shards in row order), ties go to the lowest id, which is
    the reference's cross-shard merge (``parallel/search.py:207-215``).
    On CUDA tensors the scans' k-way merge kernel (``arag_topk_merge``,
    no query scale); on CPU tensors ``merge_topk_plain``."""
    if cand_v.dim() != 3 or cand_i.shape != cand_v.shape:
        raise ValueError(f"candidates must be [lists, Q, k], got {tuple(cand_v.shape)} and "
                         f"{tuple(cand_i.shape)}")
    if _route(cand_v) == "cpu":
        return merge_topk_plain(cand_v, cand_i)
    if (cand_v.dtype != torch.float32 or cand_i.dtype != torch.int32
            or cand_i.device != cand_v.device):
        raise ValueError("the merge takes fp32 values and int32 ids on one device")
    if cand_v.shape[0] < 1 or cand_v.shape[2] < 1:
        raise ValueError(f"the merge needs at least one list of k >= 1, got {tuple(cand_v.shape)}")
    if cand_v.shape[1] == 0:
        return _empty(cand_v.shape[2], cand_v.device)
    cand_v, cand_i = cand_v.contiguous(), cand_i.contiguous()
    lib = _lib()
    with _build.on_device(cand_v.device):
        stream = torch.cuda.current_stream(cand_v.device).cuda_stream
        out = _merge(lib, cand_v, cand_i, None, stream)
    count("topk_merge")
    return out


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused top-k runs on cuda or cpu tensors, not {t.device}")
    return t.device.type


def _flat_cuda(kind, values, scales, row_masks, query_mask, queries, k, n,
               query_scale="product"):
    """Launch a flat scan on the tensor-core kernel, with the queries as
    it reads them: int8 and their scales for s8s8; the 3×TF32 halves for
    f32; bf16 for bf16 and row."""
    q_lo = qscale = None
    if kind == "s8s8":
        q8, qs = quantize_queries(queries, query_scale)
        q, qscale = q8.contiguous(), qs.contiguous()
    elif kind == "f32":
        q, q_lo = tf32_split(queries)
    else:
        q = tc_queries(queries)
    if q.shape[0] == 0:
        _check_cuda(values, q)
        return _empty(k, values.device)
    return _launch_tc(kind, values, scales, row_masks, query_mask, q, q_lo, qscale, k, n)


def fused_topk(index: torch.Tensor, queries: torch.Tensor, k: int, *,
               n_valid: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: fused scan of an f32/bf16 index [N, D] (rows L2-normalized)
    for queries [Q, D]. Returns (values [Q,k] fp32, ids [Q,k] int32)."""
    _check_k(k)
    n = _n_valid(index.shape[0], n_valid)
    if _route(index) == "cpu":
        return fused_topk_plain(index, queries, k, n_valid=n)
    out = _flat_cuda(_float_kind(index.dtype), index, None, None, None, queries, k, n)
    count("fused_topk")
    return out


def _check_int8(values: torch.Tensor, scales: torch.Tensor) -> None:
    if values.dtype != torch.int8:
        raise ValueError(f"the int8 scans take an int8 index, not {values.dtype}")
    if (scales.dtype != torch.float32 or scales.shape != (values.shape[0],)
            or scales.device != values.device):
        raise ValueError("scales must be fp32 [N] on the index's device")


def fused_topk_int8(values: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
                    k: int, *, n_valid: int | None = None, variant: str = "s8s8",
                    query_scale: str = "product"):
    """K2 (``variant="s8s8"``, the default) or K3 (``"row"``): fused scan
    of an int8 index [N, D] with per-row scales [N]. Returns (values
    [Q,k] fp32, ids [Q,k] int32). ``query_scale``: the s8s8 query scale's
    recipe (``quantize_queries``)."""
    _check_k(k)
    _check_variant(variant)
    n = _n_valid(values.shape[0], n_valid)
    if _route(values) == "cpu":
        return fused_topk_int8_plain(values, scales, queries, k, n_valid=n, variant=variant,
                                     query_scale=query_scale)
    _check_int8(values, scales)
    out = _flat_cuda(variant, values, scales.contiguous(), None, None, queries, k, n,
                     query_scale)
    count("fused_topk_int8" if variant == "s8s8" else "fused_topk_int8_row")
    return out


def fused_topk_masked(index: torch.Tensor, row_masks: torch.Tensor, query_mask: torch.Tensor,
                      queries: torch.Tensor, k: int, *, n_valid: int | None = None):
    """K4 (f32/bf16): K1 where a row counts for a query only when
    ``row_masks[row] & query_mask[query] != 0`` (int32 [N] and [Q])."""
    _check_k(k)
    n = _n_valid(index.shape[0], n_valid)
    if _route(index) == "cpu":
        return fused_topk_masked_plain(index, row_masks, query_mask, queries, k, n_valid=n)
    out = _flat_cuda(_float_kind(index.dtype), index, None, row_masks, query_mask,
                     queries, k, n)
    count("fused_topk_masked")
    return out


def fused_topk_int8_masked(values: torch.Tensor, scales: torch.Tensor, row_masks: torch.Tensor,
                           query_mask: torch.Tensor, queries: torch.Tensor, k: int, *,
                           n_valid: int | None = None, variant: str = "s8s8",
                           query_scale: str = "product"):
    """K4 (int8): K2 (s8s8, the reference's default) or K3 ("row") under
    the category filter of :func:`fused_topk_masked`. The masked s8s8
    score is ``float(acc) * row_scale`` with no bias (pallas_topk.py:
    167-168)."""
    _check_k(k)
    _check_variant(variant)
    n = _n_valid(values.shape[0], n_valid)
    if _route(values) == "cpu":
        return fused_topk_int8_masked_plain(values, scales, row_masks, query_mask, queries,
                                            k, n_valid=n, variant=variant,
                                            query_scale=query_scale)
    _check_int8(values, scales)
    out = _flat_cuda(variant, values, scales.contiguous(), row_masks, query_mask,
                     queries, k, n, query_scale)
    count("fused_topk_masked", *(("fused_topk_int8_row",) if variant == "row" else ()))
    return out


def scan_table(values: torch.Tensor, table: torch.Tensor, queries: torch.Tensor, k: int, *,
               n_valid: int, block_rows: int, q_block: int, scales=None, row_masks=None,
               query_mask=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the block-table scan (the kernel of K5 and K6) on CUDA
    tensors: tile t of ``q_block`` queries scans the blocks listed in
    ``table[t]``. Queries are fp32, rounded to bf16 for a bf16 or int8
    index, split for 3×TF32 for an f32 one. An int8 index scores with
    the row variant."""
    if q_block not in Q_BLOCKS:
        raise ValueError(f"the block-table scan takes q_block 8 or 16, not {q_block}")
    kind = "row" if values.dtype == torch.int8 else _float_kind(values.dtype)
    if kind == "row":
        _check_int8(values, scales)
    q_lo = None
    if kind == "f32":
        q, q_lo = tf32_split(queries)
    else:
        q = tc_queries(queries)
        if kind == "row":
            q = table_row_queries(q)
    if q.shape[0] == 0:
        _check_cuda(values, q)
        return _empty(k, values.device)
    return _launch_table(kind, q_block, values, scales, row_masks, query_mask, q, q_lo, table,
                         k, n_valid, block_rows)

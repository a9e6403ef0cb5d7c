"""Fused flat-scan top-k: the CUDA kernels K1 and K2 and their plain versions.

The port of ``arxiv_rag_tpu/ops/pallas_topk.py`` (``fused_topk`` :810 and
``fused_topk_int8`` :928 with its default s8s8 variant). The kernels are
in ``csrc/fused_topk.cu``; their design and bound are noted there.

Contract, shared with the TPU kernel: values [Q,k] fp32 and ids [Q,k]
int32, k ≤ 128; scores ordered descending with the lowest row id first
among equal scores; rows with id ≥ ``n_valid`` never appear; slots that
no row fills hold (-inf, -1).

- ``fused_topk``: an f32 or bf16 index; queries cast to the index dtype;
  fp32 accumulation (full fp32 for an f32 index).
- ``fused_topk_int8`` (s8s8): queries quantized per row to int8 (scale
  max(max|q|, 1e-8)·float32(1/127), round half to even, clip ±127, as
  ``pallas_topk.py:904-908`` compiles); exact s32 products; ranked by
  ``float(acc) * row_scale``; the k survivors times the query scale.

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes
the plain version for a CPU tensor. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from arxiv_rag_tpu_torch.ops.topk import NEG_INF, topk_padded

K_MAX = 128
_QT = 16  # queries per scan block (csrc/fused_topk.cu kQT)
_TILE_ROWS = 512  # rows per scan tile (kTileRows)
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_PLAIN_SCORE_ELEMS = 1 << 26  # plain versions score this many [q, row] pairs at a time

LAUNCHES = {"fused_topk": 0, "fused_topk_int8": 0}
_COUNT_LOCK = threading.Lock()
_LIB: list[ctypes.CDLL] = []


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


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


def quantize_queries(queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """s8s8 query quantization: (int8 [Q,D], fp32 scales [Q]). The scale is
    max(max|q|, 1e-8) times float32(1/127): inside its jit the reference's
    ``/ 127.0`` compiles to that product, which differs from the quotient
    in the last bit for some rows."""
    qf = queries.to(torch.float32)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=qf.device)
    qs = torch.clamp(torch.amax(torch.abs(qf), dim=1, keepdim=True), min=1e-8) * inv127
    q8 = torch.clamp(torch.round(qf / qs), -127, 127).to(torch.int8)
    return q8, qs[:, 0]


# -- plain versions ------------------------------------------------------------


def _kernel_order(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k in the kernels' order; -inf entries are empty slots (-inf, -1)."""
    vals, ids = topk_padded(scores, k)
    ids = torch.where(vals == NEG_INF, torch.full_like(ids, -1), ids)
    return vals, ids.to(torch.int32)


def _query_chunks(nq: int, n_rows: int) -> tuple[range, int]:
    step = max(1, _PLAIN_SCORE_ELEMS // max(1, n_rows))
    return range(0, nq, step), step


def fused_topk_plain(index, queries, k, *, n_valid=None):
    """K1's function in plain PyTorch: fp32 scores (queries cast to the
    index dtype first), rows ≥ n_valid at -inf, stable top-k."""
    _check_k(k)
    n = _n_valid(index.shape[0], n_valid)
    x = index.to(torch.float32)
    q = queries.to(index.dtype).to(torch.float32)
    starts, step = _query_chunks(q.shape[0], x.shape[0])
    vals, ids = [], []
    for s in starts:
        scores = q[s : s + step] @ x.T
        scores[:, n:] = NEG_INF
        v, i = _kernel_order(scores, k)
        vals.append(v)
        ids.append(i)
    if not vals:
        return _empty(k, index.device)
    return torch.cat(vals), torch.cat(ids)


def fused_topk_int8_plain(values, scales, queries, k, *, n_valid=None):
    """K2's function in plain PyTorch: the int8 products summed in fp32
    (exact: |s8·s8| ≤ 16129 and 768 of them stay below 2^24), times the
    row scale, ranked, then the survivors times the query scale."""
    _check_k(k)
    n = _n_valid(values.shape[0], n_valid)
    q8, qs = quantize_queries(queries)
    x = values.to(torch.float32)
    row_scales = scales.to(torch.float32)
    starts, step = _query_chunks(q8.shape[0], x.shape[0])
    vals, ids = [], []
    for s in starts:
        scores = (q8[s : s + step].to(torch.float32) @ x.T) * row_scales[None, :]
        scores[:, n:] = NEG_INF
        v, i = _kernel_order(scores, k)
        vals.append(v * qs[s : s + step, None])
        ids.append(i)
    if not vals:
        return _empty(k, values.device)
    return torch.cat(vals), torch.cat(ids)


def _empty(k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty((0, k), dtype=torch.float32, device=device),
            torch.empty((0, k), dtype=torch.int32, device=device))


# -- CUDA kernels --------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    if not _LIB:
        from arxiv_rag_tpu_torch.ops import _build

        lib = _build.load("fused_topk")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.arag_topk_scan.argtypes = [i32, p, p, p, i64, i64, i32, i32, i32, i64, i32, p, p, p]
        lib.arag_topk_scan.restype = i32
        lib.arag_topk_merge.argtypes = [p, p, i32, i32, i32, p, p, p, p]
        lib.arag_topk_merge.restype = i32
        lib.arag_topk_scan_smem.argtypes = [i32, i32]
        lib.arag_topk_scan_smem.restype = ctypes.c_size_t
        lib.arag_error_string.argtypes = [i32]
        lib.arag_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.arag_error_string(err).decode()})")


def plan_chunks(n_rows: int, nq: int, sm_count: int) -> tuple[int, int]:
    """(rows per chunk, chunks): about four scan blocks per SM, chunks a
    whole number of 512-row tiles."""
    q_tiles = -(-nq // _QT)
    tiles = max(1, -(-n_rows // _TILE_ROWS))
    n_chunks = min(tiles, max(1, -(-4 * sm_count // q_tiles)))
    per_chunk = -(-tiles // n_chunks)
    return per_chunk * _TILE_ROWS, -(-tiles // per_chunk)


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


def _launch(kind_dtype, x, scales, q, qscale, k, n_valid):
    lib = _lib()
    dev = x.device
    d = x.shape[1]
    n_rows = n_valid  # rows past n_valid (padding) are never read
    nq = q.shape[0]
    props = torch.cuda.get_device_properties(dev)
    kind = _KIND[kind_dtype]
    smem = lib.arag_topk_scan_smem(kind, d)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    if smem > limit:
        raise ValueError(f"D={d} needs {smem} bytes of shared memory per block; "
                         f"the card allows {limit}")
    chunk_rows, n_chunks = plan_chunks(n_rows, nq, props.multi_processor_count)
    cand_v = torch.empty((n_chunks, nq, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((n_chunks, nq, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.arag_topk_scan(
            kind, x.data_ptr(), None if scales is None else scales.data_ptr(),
            q.data_ptr(), n_rows, n_valid, d, nq, k, chunk_rows, n_chunks,
            cand_v.data_ptr(), cand_i.data_ptr(), stream,
        )
        _raise_on(lib, err, "fused top-k scan")
        err = lib.arag_topk_merge(
            cand_v.data_ptr(), cand_i.data_ptr(), n_chunks, nq, k,
            None if qscale is None else qscale.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), stream,
        )
        _raise_on(lib, err, "fused top-k merge")
    return out_v, out_i


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused top-k runs on cuda or cpu tensors, not {t.device}")
    return t.device.type


def fused_topk(index: torch.Tensor, queries: torch.Tensor, k: int, *,
               n_valid: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: fused scan of an f32/bf16 index [N, D] (rows L2-normalized)
    for queries [Q, D]. Returns (values [Q,k] fp32, ids [Q,k] int32)."""
    _check_k(k)
    n = _n_valid(index.shape[0], n_valid)
    if _route(index) == "cpu":
        return fused_topk_plain(index, queries, k, n_valid=n)
    if index.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_topk takes an f32 or bf16 index, not {index.dtype}")
    q = queries.to(index.dtype).contiguous()
    _check_cuda(index, q)
    if q.shape[0] == 0:
        return _empty(k, index.device)
    out = _launch(index.dtype, index, None, q, None, k, n)
    _count("fused_topk")
    return out


def fused_topk_int8(values: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
                    k: int, *, n_valid: int | None = None):
    """K2 (s8s8): fused scan of an int8 index [N, D] with per-row scales
    [N]. Returns (values [Q,k] fp32, ids [Q,k] int32)."""
    _check_k(k)
    n = _n_valid(values.shape[0], n_valid)
    if _route(values) == "cpu":
        return fused_topk_int8_plain(values, scales, queries, k, n_valid=n)
    if values.dtype != torch.int8:
        raise ValueError(f"fused_topk_int8 takes an int8 index, not {values.dtype}")
    if (scales.dtype != torch.float32 or scales.shape != (values.shape[0],)
            or scales.device != values.device):
        raise ValueError("scales must be fp32 [N] on the index's device")
    q8, qs = quantize_queries(queries)
    _check_cuda(values, q8)
    if q8.shape[0] == 0:
        return _empty(k, values.device)
    out = _launch(torch.int8, values, scales.contiguous(), q8.contiguous(),
                  qs.contiguous(), k, n)
    _count("fused_topk_int8")
    return out

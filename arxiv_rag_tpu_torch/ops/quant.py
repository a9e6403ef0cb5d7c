"""int8 symmetric quantization for the device-resident index.

The port of ``arxiv_rag_tpu/ops/quant.py``: per-row scales absmax/127
(floor 1e-12), values rounded half to even and clipped to ±127, so for
L2-normalized rows score(q, x_i) ≈ s_i · (q · q_i).
"""

from __future__ import annotations

import torch

from arxiv_rag_tpu_torch.ops.topk import NEG_INF, topk_padded


def quantize_int8(index: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N,D] float → ([N,D] int8 values, [N] fp32 per-row scales). The
    scale is the true quotient on every device: CUDA divides by a CPU
    scalar as a product with its reciprocal, so the divisor is a tensor on
    the index's device."""
    x = index.to(torch.float32)
    absmax = torch.amax(torch.abs(x), dim=1)
    d127 = torch.tensor(127.0, dtype=torch.float32, device=x.device)
    scales = torch.clamp(absmax, min=1e-12) / d127
    q = torch.clamp(torch.round(x / scales[:, None]), -127, 127).to(torch.int8)
    return q, scales


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return values.to(torch.float32) * scales[:, None]


def int8_search(values, scales, queries, k, row_masks=None, query_mask=None):
    """Unfused scan over an int8 index: bf16 queries against the int8
    values (exact in fp32), scaled per row. Without masks, rows of scale
    0 (padding) score -inf; with masks, rows count only where
    ``row_masks & query_mask != 0``."""
    q = queries.to(torch.bfloat16).to(torch.float32)
    scores = (q @ values.to(torch.float32).T) * scales[None, :]
    if row_masks is not None and query_mask is not None:
        keep = (row_masks.to(torch.int64)[None, :] & query_mask.to(torch.int64)[:, None]) != 0
    else:
        keep = (scales > 0)[None, :]
    scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    return topk_padded(scores, k)

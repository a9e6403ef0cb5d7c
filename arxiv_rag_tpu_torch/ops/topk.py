"""Flat cosine top-k: plain PyTorch scans and the recall oracle.

The port of ``arxiv_rag_tpu/ops/topk.py``:

- ``cosine_topk_numpy``: exact fp32 CPU scan, the recall oracle;
- ``flat_search`` / ``masked_flat_search``: scores Q·Xᵀ in fp32 (queries
  cast to the index dtype first, then both operands to fp32, so a bf16
  index is scored exactly as a bf16 matmul with fp32 accumulation, and
  an f32 index at full precision), then top-k;
- ``topk_padded``: top-k clamped to the row count, short results padded
  with (-inf, -1).

Ties go to the lowest index, as ``lax.top_k`` does: ``torch.topk`` does
not promise that order, so the top-k is a stable descending sort.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")


def scores_f32(index: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """[Q, N] fp32 scores: queries cast to the index dtype, then both
    operands to fp32 (never a bf16 matmul, whose output rounds to bf16)."""
    q = queries.to(index.dtype).to(torch.float32)
    return q @ index.to(torch.float32).T


def topk_padded(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values [Q,k], ids [Q,k] int64): descending, lowest id first among
    equal scores; short results pad with (-inf, -1)."""
    kk = min(k, scores.shape[-1])
    values, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    values, ids = values[:, :kk], ids[:, :kk]
    if kk < k:
        pad = k - kk
        values = torch.nn.functional.pad(values, (0, pad), value=NEG_INF)
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    return values, ids


def flat_search(index: torch.Tensor, queries: torch.Tensor, k: int):
    """Unfused scan: fp32 scores, then top-k."""
    return topk_padded(scores_f32(index, queries), k)


def masked_flat_search(index, row_masks, query_mask, queries, k):
    """Filtered scan: a row counts for a query only when
    ``row_masks & query_mask != 0`` (uint32 bit patterns held in int64);
    other rows score -inf."""
    scores = scores_f32(index, queries)
    eligible = (row_masks.to(torch.int64)[None, :] & query_mask.to(torch.int64)[:, None]) != 0
    scores = torch.where(eligible, scores, torch.full_like(scores, NEG_INF))
    return topk_padded(scores, k)


def cosine_topk_numpy(index: np.ndarray, queries: np.ndarray, k: int):
    """Exact fp32 scan oracle; ties broken by lower index."""
    scores = queries.astype(np.float32) @ index.astype(np.float32).T
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=1), idx.astype(np.int64)


def make_row_masks(row_categories: np.ndarray, categories: list[str]) -> np.ndarray:
    """[N] uint32 bitmasks from per-row category strings."""
    if len(categories) > 32:
        raise ValueError("more than 32 categories needs a wider mask")
    bit_of = {c: np.uint32(1 << i) for i, c in enumerate(categories)}
    return np.array([bit_of.get(c, np.uint32(0)) for c in row_categories], np.uint32)


def recall_at_k(
    found: np.ndarray, oracle: np.ndarray, oracle_scores: np.ndarray | None = None,
    tie_tol: float = 1e-6, candidate_scores: np.ndarray | None = None,
) -> float:
    """Tie-tolerant recall@k: a found id counts if it is in the oracle set
    or its score is within tie_tol of the oracle's k-th score."""
    q, k = oracle.shape
    hits = 0
    for row in range(q):
        oracle_set = set(oracle[row].tolist())
        for j, cand in enumerate(found[row].tolist()):
            if cand in oracle_set:
                hits += 1
            elif (
                oracle_scores is not None
                and candidate_scores is not None
                and candidate_scores[row, j] >= oracle_scores[row, -1] - tie_tol
            ):
                hits += 1
    return hits / (q * k)

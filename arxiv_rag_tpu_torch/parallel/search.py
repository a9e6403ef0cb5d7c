"""Sharded flat search in one process: shard-local top-k, then a lossless
merge of the shards' lists.

The port of ``arxiv_rag_tpu/parallel/search.py`` (``sharded_topk`` :123,
``_pallas_local`` :67, ``_local_scan_xla`` :33). The index lies
row-sharded over a :class:`~arxiv_rag_tpu_torch.parallel.mesh.DeviceMesh`
(``shard_index_rows``). Each shard runs the port's fused scan on its own
device, every variant: f32/bf16 (K1), int8 s8s8 (K2, the default, its
query scale the quotient of the reference's route rather than the
single-device product: ``_fused_local``) or "row" (K3), and their
masked forms (K4), with its local ``n_valid`` =
clip(n_valid − offset, 0, shard_rows); local ids are offset to global
ids (-1 stays -1). All shards are launched before any result is copied,
so that shards on different cards overlap. The shards' [Q, k] lists are
then stacked in shard order on ``mesh.devices[0]`` and merged
(``ops/fused_topk.py::merge_topk``: the scans' own k-way merge kernel on
the card, a stable sort on the CPU). Per query the global top-k is the
top-k of the union of the shards' top-ks, among equal scores the lowest
global id first, as the reference's ``lax.top_k`` over shard-ordered
candidates (:207-215), so the merge is lossless and a sharded scan
returns what one scan of the whole index returns.

k > 128 (beyond the fused kernels' lists) scans each shard with the
plain scan that ``_local_scan_xla`` is: fp32 scores of queries cast to
the index dtype (int8: bf16 queries × int8 rows × row scale), padding
and filtered rows at -inf.

Multi-process meshes (``torch.distributed``, the cross-process gather)
are not here.
"""

from __future__ import annotations

from typing import Sequence

import torch

from arxiv_rag_tpu_torch.ops import fused_topk as ft
from arxiv_rag_tpu_torch.ops.topk import NEG_INF, topk_padded
from arxiv_rag_tpu_torch.parallel.mesh import DeviceMesh, replicate


def _local_scan_plain(shard, q, offset, n_valid, k, row_masks=None, query_mask=None,
                      scales=None):
    """One shard's exact scan in plain PyTorch (``_local_scan_xla``):
    (values [Q, k], global ids [Q, k]), -1 where no row fills a slot."""
    if scales is not None:  # int8 storage, bf16 compute
        qf = q.to(torch.bfloat16).to(torch.float32)
        scores = (qf @ shard.to(torch.float32).T) * scales[None, :]
    else:
        scores = q.to(shard.dtype).to(torch.float32) @ shard.to(torch.float32).T
    gids = offset + torch.arange(shard.shape[0], device=shard.device)
    valid = (gids < n_valid)[None, :]
    if row_masks is not None:
        valid = valid & ((row_masks[None, :] & query_mask[:, None]) != 0)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    vals, ids = topk_padded(scores, k)
    out = torch.where(vals == NEG_INF, torch.full_like(ids, -1), gids[ids.clamp(min=0)])
    return vals, out.to(torch.int32)


def _fused_local(shard, q, k, local_valid, row_masks=None, query_mask=None, scales=None,
                 int8_variant="s8s8"):
    """One shard's fused scan (``_pallas_local``): local ids. The s8s8
    query scale is the quotient the reference's ``shard_map`` computes
    (:100-101), where its single-device jit multiplies
    (``ops/fused_topk.py::quantize_queries``)."""
    if scales is not None:
        kw = dict(n_valid=local_valid, variant=int8_variant, query_scale="quotient")
        if row_masks is not None:
            return ft.fused_topk_int8_masked(shard, scales, row_masks, query_mask, q, k, **kw)
        return ft.fused_topk_int8(shard, scales, q, k, **kw)
    if row_masks is not None:
        return ft.fused_topk_masked(shard, row_masks, query_mask, q, k, n_valid=local_valid)
    return ft.fused_topk(shard, q, k, n_valid=local_valid)


def merge_shards(vals: Sequence[torch.Tensor], gids: Sequence[torch.Tensor],
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """The shards' [Q, k] lists (global ids, in shard order) copied to
    ``device`` and merged losslessly: (values [Q, k], ids [Q, k])."""
    cand_v = torch.stack([v.to(device) for v in vals])
    cand_i = torch.stack([i.to(device) for i in gids])
    return ft.merge_topk(cand_v, cand_i)


def _check_shards(name: str, shards, mesh: DeviceMesh, rows: int) -> None:
    if len(shards) != mesh.size:
        raise ValueError(f"{name}: {len(shards)} shards for a mesh of {mesh.size}")
    for s, (t, dev) in enumerate(zip(shards, mesh.devices)):
        if t.device != dev:
            raise ValueError(f"{name}: shard {s} lies on {t.device}, its mesh entry is {dev}")
        if t.shape[0] != rows:
            raise ValueError(f"{name}: shard {s} has {t.shape[0]} rows, shard 0 {rows}")


def shard_candidates(
    index_shards: Sequence[torch.Tensor],
    queries: torch.Tensor,
    k: int,
    mesh: DeviceMesh,
    *,
    n_valid: int | None = None,
    row_masks: Sequence[torch.Tensor] | None = None,
    query_mask: torch.Tensor | None = None,
    scales: Sequence[torch.Tensor] | None = None,
    int8_variant: str = "s8s8",
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Each shard's top-k, launched on its device before any result moves:
    (values, global ids), lists of [Q, k] in shard order (the arguments
    of :func:`sharded_topk`)."""
    ft._check_variant(int8_variant)
    if len(index_shards) != mesh.size:
        raise ValueError(f"{len(index_shards)} index shards for a mesh of {mesh.size}")
    shard_rows = index_shards[0].shape[0]
    masked = row_masks is not None and query_mask is not None
    for name, side in (("index", index_shards), ("scales", scales),
                       ("row_masks", row_masks if masked else None)):
        if side is not None:
            _check_shards(name, side, mesh, shard_rows)
    total = shard_rows * mesh.size
    n_valid = total if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= total:
        raise ValueError(f"n_valid {n_valid} outside [0, {total}]")
    qs = replicate(queries, mesh)
    qms = replicate(query_mask, mesh) if masked else [None] * mesh.size
    vals, gids = [], []
    for s in range(mesh.size):
        offset = s * shard_rows
        rm = row_masks[s] if masked else None
        sc = None if scales is None else scales[s]
        if k > ft.K_MAX:
            v, g = _local_scan_plain(index_shards[s], qs[s], offset, n_valid, k,
                                     row_masks=rm, query_mask=qms[s], scales=sc)
        else:
            local_valid = min(max(n_valid - offset, 0), shard_rows)
            v, i = _fused_local(index_shards[s], qs[s], k, local_valid, row_masks=rm,
                                query_mask=qms[s], scales=sc, int8_variant=int8_variant)
            g = torch.where(i >= 0, i + offset, torch.full_like(i, -1))
        vals.append(v)
        gids.append(g)
    return vals, gids


def sharded_topk(
    index_shards: Sequence[torch.Tensor],
    queries: torch.Tensor,
    k: int,
    mesh: DeviceMesh,
    **kw,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over a row-sharded index: (values [Q, k] fp32, global
    ids [Q, k] int32) on ``mesh.devices[0]``.

    ``index_shards``: equal [shard_rows, D] shards, shard s on
    ``mesh.devices[s]`` (``shard_index_rows``). Keywords: rows ≥
    ``n_valid`` (all by default) never return; ``row_masks`` (int32
    [shard_rows] per shard) with ``query_mask`` (int32 [Q]) filters by
    category; ``scales`` (fp32 [shard_rows] per shard) marks an int8
    index, scored s8s8 by default or in the "row" mode
    (``int8_variant``)."""
    vals, gids = shard_candidates(index_shards, queries, k, mesh, **kw)
    return merge_shards(vals, gids, mesh.devices[0])

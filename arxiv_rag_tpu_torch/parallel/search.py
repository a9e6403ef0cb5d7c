"""Sharded flat search: shard-local top-k, then a lossless merge of the
shards' lists, in one process or across several.

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
then stacked in shard order on ``mesh.home`` (``mesh.devices[0]`` in one
process) and merged
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

On a mesh that spans processes (``parallel/distributed.py``) each
process scans only its own shards; ``merge_shards`` gathers every
process's [Q, k] lists (``torch.distributed.all_gather``: on the card
under NCCL, through host memory under gloo), puts them in global shard
order, never in arrival order, and merges them on the process's own
device. Every process returns the same result, as the reference's
replicated ``lax.top_k`` after its ``all_gather`` (:207-215).
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


def gather_shards(vals: Sequence[torch.Tensor | None], gids: Sequence[torch.Tensor | None],
                  mesh: DeviceMesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Every shard's [Q, k] list (global ids), stacked in shard order on
    ``mesh.home``: ([nd, Q, k] fp32, [nd, Q, k] int32). On a mesh that
    spans processes, one ``all_gather`` of this process's lists (values
    viewed as int32 beside the ids) brings the others' in."""
    home = mesh.home
    if not mesh.spans_processes:
        return (torch.stack([v.to(home) for v in vals]),
                torch.stack([i.to(home) for i in gids]))
    import torch.distributed as dist

    local = mesh.local
    mine = torch.stack([torch.stack([vals[s].to(home).view(torch.int32), gids[s].to(home)])
                        for s in local])  # [n_local, 2, Q, k]
    if dist.get_backend() == "gloo":  # gloo gathers host tensors: the copy is explicit
        mine = mine.cpu()
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine.contiguous())
    seen: dict[int, int] = {}
    order = []
    for r in mesh.ranks:  # entry s is its owner's next list
        order.append(parts[r][seen.get(r, 0)])
        seen[r] = seen.get(r, 0) + 1
    cand = torch.stack(order).to(home)
    return cand[:, 0].view(torch.float32), cand[:, 1]


def merge_shards(vals: Sequence[torch.Tensor | None], gids: Sequence[torch.Tensor | None],
                 mesh: DeviceMesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The shards' [Q, k] lists (global ids, in shard order; None for
    another process's shard) gathered to ``mesh.home`` and merged
    losslessly: (values [Q, k], ids [Q, k])."""
    return ft.merge_topk(*gather_shards(vals, gids, mesh))


def _check_shards(name: str, shards, mesh: DeviceMesh, rows: int) -> None:
    if len(shards) != mesh.size:
        raise ValueError(f"{name}: {len(shards)} shards for a mesh of {mesh.size}")
    for s in mesh.local:
        t, dev = shards[s], mesh.devices[s]
        if t is None or t.device != dev:
            raise ValueError(f"{name}: shard {s} lies on {t if t is None else t.device}, its "
                             f"mesh entry is {dev}")
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
    """Each local shard's top-k, launched on its device before any result
    moves: (values, global ids), lists of [Q, k] in shard order, None for
    another process's shards (the arguments of :func:`sharded_topk`)."""
    ft._check_variant(int8_variant)
    if len(index_shards) != mesh.size:
        raise ValueError(f"{len(index_shards)} index shards for a mesh of {mesh.size}")
    shard_rows = index_shards[mesh.local[0]].shape[0]
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
    vals: list = [None] * mesh.size
    gids: list = [None] * mesh.size
    for s in mesh.local:
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
        vals[s], gids[s] = v, g
    return vals, gids


def sharded_topk(
    index_shards: Sequence[torch.Tensor],
    queries: torch.Tensor,
    k: int,
    mesh: DeviceMesh,
    **kw,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over a row-sharded index: (values [Q, k] fp32, global
    ids [Q, k] int32) on ``mesh.home``, the same on every process.

    ``index_shards``: equal [shard_rows, D] shards, shard s on
    ``mesh.devices[s]`` (``shard_index_rows``; this process's only, on a
    mesh that spans processes). Keywords: rows ≥
    ``n_valid`` (all by default) never return; ``row_masks`` (int32
    [shard_rows] per shard) with ``query_mask`` (int32 [Q]) filters by
    category; ``scales`` (fp32 [shard_rows] per shard) marks an int8
    index, scored s8s8 by default or in the "row" mode
    (``int8_variant``)."""
    vals, gids = shard_candidates(index_shards, queries, k, mesh, **kw)
    return merge_shards(vals, gids, mesh)

"""IVF (cluster-pruned) top-k: scan only the probed blocks (K5, K6).

The port of ``arxiv_rag_tpu/ops/pallas_ivf.py``. The scan is
``tc_table_kernel`` in ``csrc/fused_topk.cu`` (tensor cores; launched
through ``ops.fused_topk.scan_table``): each tile of ``q_block`` (8 or
16) queries scans only the block ids in its row of a [tiles, width]
table, its (visit, 128-row slice) items spread over the card.

Table contract (the planners keep it): each row lists the tile's probed
block ids ascending, each real block once, padded with the dead block
id, whose rows all lie at ids ≥ ``n_valid`` (``pad_index_for_ivf``).
Ascending ids make the reference's earlier-visit-wins tie order equal to
the kernels' lowest-id-wins order, and unique ids are what the kernel's
merge assumes; the plain version checks both. With the dead block the
largest id, a row's real visits come first: the kernel divides the
items up to the last real one among its splits.

- ``ivf_topk`` / ``ivf_topk_int8`` / ``ivf_topk_masked`` /
  ``ivf_topk_int8_masked``: K5 on a host-planned table (:220, :266, :365,
  :315). An int8 index scores with the row variant (K3), as in the
  reference (:123). Returned ids are LOCAL (IVF row order).
- ``ivf_topk_device``: K6 (:482) — the centroid top-nprobe (fp32 matmul,
  stable top-k), the device planner ``device_plan`` (:433) and the scan,
  with nothing read back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from arxiv_rag_tpu_torch.ops import fused_topk as ft
from arxiv_rag_tpu_torch.ops.topk import NEG_INF, flat_search


def pad_index_for_ivf(values: torch.Tensor, block_rows: int, scales=None, row_masks=None):
    """Pad rows with zeros to a block multiple PLUS one all-zero "dead"
    block (the table's pad target). Returns (values, scales, row_masks,
    dead_block_id), on the inputs' device."""
    n = values.shape[0]
    pad = (-n) % block_rows + block_rows  # tail align + one dead block

    def padded(t):
        if t is None:
            return None
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])

    values = padded(values)
    return values, padded(scales), padded(row_masks), values.shape[0] // block_rows - 1


def cluster_block_table(offsets: np.ndarray, block_rows: int, dead_block: int) -> np.ndarray:
    """[C, maxb] int32: each cluster's covering block ids (ascending),
    dead-padded. ``maxb`` is the widest cluster's block count — the
    static expansion factor of the device planner."""
    off = np.asarray(offsets, np.int64)
    lo = off[:-1] // block_rows
    hi = -(-off[1:] // block_rows)  # exclusive
    counts = np.where(off[1:] > off[:-1], np.maximum(hi - lo, 0), 0)
    maxb = max(1, int(counts.max()))
    steps = np.arange(maxb, dtype=np.int64)[None, :]
    table = lo[:, None] + steps
    table = np.where(steps < counts[:, None], table, dead_block)
    return table.astype(np.int32)


def device_plan(cids: torch.Tensor, cb: torch.Tensor, dead: int, q_block: int,
                width: int) -> torch.Tensor:
    """[tiles, width] int32 block table from probed cluster ids [Q,
    nprobe], in tensor ops on their device: gather each tile's clusters'
    covering blocks, sort, turn duplicates into the dead id and sort
    again (dead is the largest block id, so the real blocks stay
    ascending up front)."""
    tiles = cids.shape[0] // q_block
    blocks = cb[cids.reshape(tiles, -1)]  # [tiles, q_block*nprobe, maxb]
    flat = torch.sort(blocks.reshape(tiles, -1), dim=1).values
    dup = torch.zeros_like(flat, dtype=torch.bool)
    dup[:, 1:] = flat[:, 1:] == flat[:, :-1]
    flat = torch.sort(torch.where(dup, dead, flat), dim=1).values
    return flat[:, :width].contiguous()


# -- plain version ---------------------------------------------------------------


def ivf_topk_plain(values, blkids, queries, k, *, n_valid, block_rows, q_block=8,
                   scales=None, row_masks=None, query_mask=None):
    """The block-table scan in plain PyTorch: each tile's queries against
    the rows of its listed blocks (rows ≥ n_valid dropped), scored as the
    kernel of the index dtype scores them, top-k in (score desc, id asc)
    order. Raises if a row lists a real block twice or out of order."""
    ft._check_k(k)
    q = ft.round_queries(queries, values.dtype)
    table = torch.as_tensor(blkids).to(values.device, torch.int64)
    nq = q.shape[0]
    if table.shape[0] != -(-nq // q_block):
        raise ValueError(f"block table has {table.shape[0]} rows for {nq} queries "
                         f"in tiles of {q_block}")
    out_v = torch.full((nq, k), NEG_INF, dtype=torch.float32, device=values.device)
    out_i = torch.full((nq, k), -1, dtype=torch.int32, device=values.device)
    offs = torch.arange(block_rows, device=values.device)
    for t in range(table.shape[0]):
        blocks = table[t]
        real = blocks[(blocks >= 0) & (blocks * block_rows < n_valid)]
        if bool((real[1:] <= real[:-1]).any()):
            raise ValueError(f"block table row {t} must list each real block once, "
                             "ascending")
        rows = (real[:, None] * block_rows + offs[None, :]).reshape(-1)
        rows = rows[rows < n_valid]
        if rows.numel() == 0:  # only dead visits: the tile's slots stay (-inf, -1)
            continue
        sl = slice(t * q_block, min((t + 1) * q_block, nq))
        v, i = ft.score_plain(
            values[rows].to(torch.float32), q[sl], k,
            scales=None if scales is None else scales[rows].to(torch.float32),
            row_masks=None if row_masks is None else row_masks[rows],
            query_mask=None if query_mask is None else query_mask[sl],
        )
        out_v[sl] = v
        out_i[sl] = torch.where(i >= 0, rows[i.clamp(min=0).long()].to(torch.int32), -1)
    return out_v, out_i


# -- K5: host-planned tables ------------------------------------------------------


def _table_scan(values, blkids, queries, k, *, n_valid, block_rows, q_block, scales=None,
                row_masks=None, query_mask=None, counter="ivf_topk"):
    if values.shape[0] % block_rows:
        raise ValueError(f"IVF index must be padded to a block multiple (got "
                         f"{values.shape[0]} rows, block_rows={block_rows}); see "
                         "pad_index_for_ivf")
    if values.device.type == "cpu":
        return ivf_topk_plain(values, blkids, queries, k, n_valid=n_valid,
                              block_rows=block_rows, q_block=q_block, scales=scales,
                              row_masks=row_masks, query_mask=query_mask)
    ft._check_k(k)
    table = torch.as_tensor(blkids).to(values.device, torch.int32).contiguous()
    out = ft.scan_table(values, table, queries, k, n_valid=n_valid, block_rows=block_rows,
                        q_block=q_block, scales=scales, row_masks=row_masks,
                        query_mask=query_mask)
    ft.count(counter, *(("fused_topk_int8_row",) if values.dtype == torch.int8 else ()))
    return out


def ivf_topk(index, blkids, queries, k, *, n_valid, block_rows, q_block=8):
    """K5: cluster-pruned top-k over a padded f32/bf16 ``index`` for the
    per-tile block table ``blkids`` [tiles, width]. Returns (values
    [Q,k], LOCAL row ids [Q,k]); unfilled slots are (-inf, -1)."""
    return _table_scan(index, blkids, queries, k, n_valid=n_valid, block_rows=block_rows,
                       q_block=q_block)


def ivf_topk_int8(values, scales, blkids, queries, k, *, n_valid, block_rows, q_block=8):
    """K5 over an int8 index, scored with the row variant (K3)."""
    return _table_scan(values, blkids, queries, k, n_valid=n_valid, block_rows=block_rows,
                       q_block=q_block, scales=scales)


def ivf_topk_masked(index, row_masks, query_mask, blkids, queries, k, *, n_valid,
                    block_rows, q_block=8):
    """K5 under the category filter (``row_masks`` in IVF row order)."""
    return _table_scan(index, blkids, queries, k, n_valid=n_valid, block_rows=block_rows,
                       q_block=q_block, row_masks=row_masks, query_mask=query_mask)


def ivf_topk_int8_masked(values, scales, row_masks, query_mask, blkids, queries, k, *,
                         n_valid, block_rows, q_block=8):
    """K5 over an int8 index (row variant) under the category filter."""
    return _table_scan(values, blkids, queries, k, n_valid=n_valid, block_rows=block_rows,
                       q_block=q_block, scales=scales, row_masks=row_masks,
                       query_mask=query_mask)


# -- K6: device-planned ------------------------------------------------------------


def device_table_width(n_blocks: int, cb_width: int, nprobe: int, q_block: int) -> int:
    """The device plan's static table width (dead visits included)."""
    return max(1, min(q_block * nprobe * cb_width, n_blocks - 1))


def ivf_topk_device(values, cb, centroids, queries, k, *, nprobe, n_valid, block_rows,
                    q_block=8, scales=None, row_masks=None, query_mask=None):
    """K6: probe, plan and scan in one dispatch with no host sync.

    ``cb`` is :func:`cluster_block_table` on the values' device;
    ``queries`` must already be padded to a ``q_block`` multiple (callers
    repeat the last query so pad tiles share its probes). Covers the same
    rows as the host planner, so the results equal ``ivf_topk*``'s.
    Returns (values [Q,k], LOCAL row ids [Q,k])."""
    qn = queries.shape[0]
    if qn % q_block:
        raise ValueError(f"query count {qn} not a multiple of q_block {q_block}")
    n_blocks = values.shape[0] // block_rows
    nprobe = min(nprobe, cb.shape[0])
    width = device_table_width(n_blocks, cb.shape[1], nprobe, q_block)
    q = queries.to(torch.float32)
    _, cids = flat_search(centroids, q, nprobe)
    table = device_plan(cids, cb, n_blocks - 1, q_block, width)
    return _table_scan(values, table, q, k, n_valid=n_valid, block_rows=block_rows,
                       q_block=q_block, scales=scales, row_masks=row_masks,
                       query_mask=query_mask, counter="ivf_topk_device")

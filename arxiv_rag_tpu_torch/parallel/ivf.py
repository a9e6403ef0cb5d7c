"""Sharded IVF: cluster-partitioned shards and the lossless merge of
their lists, in one process or across several.

The port of ``arxiv_rag_tpu/parallel/ivf.py`` (``partition_clusters``
:56, ``ShardedIVF`` :70). An :class:`~arxiv_rag_tpu_torch.index.ivf.IVFIndex`
lays its rows out sorted by cluster, so a shard is a contiguous slice of
that row order: the clusters are cut into ``nd`` contiguous ranges of
near-equal row counts (``partition_clusters``), each shard padded to a
common ``rows_pad`` (a block multiple plus one dead block). ``to_device``
copies each shard's rows from the IVF layout, wherever it lies, straight
into its buffer on its mesh device: no stacked copy of all shards exists.

Per call (``search``): the queries pad to a ``q_block`` multiple by
repeating the last one; then either

- ``plan="host"``: the centroid top-nprobe on ``mesh.home``, one
  block table per shard planned on the host (``plan_blocks``: each query
  tile's probed clusters restricted to the shard's range, in shard-local
  block ids, dead-padded to a width shared by the shards), and per shard
  the block-table scan (K5, ``ops/ivf.py::_table_scan``); or
- ``plan="device"``: per shard the probe, the device planner over the
  shard's own cluster → block table (``_shard_cluster_blocks``) and the
  scan, with no host sync (K6, ``ops/ivf.py::ivf_topk_device``).

Each shard scans with its own ``n_valid`` (its row count), offsets its
hits by ``row_starts[s]`` into global IVF row ids, and the shards' lists
merge on ``mesh.home`` as in ``parallel/search.py``; ids map through
``ivf.perm`` to dense rows. A query tile whose probes all lie on other
shards visits that shard's dead block only and adds only empty slots.
On a mesh that spans processes each process places and scans only its
own shards (the host planner plans every shard, so the table width is
the same on every process, and keeps its own), and the lists gather
across processes before the merge.

Shard boundaries fall at cluster edges, not at block edges, so a shard's
block covers other rows than a block of the single-device layout: below
full probe the sharded IVF is held to the reference's recall and
coverage, not to the single-device IVF's answers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from arxiv_rag_tpu_torch.index.ivf import IVFIndex
from arxiv_rag_tpu_torch.ops.ivf import _table_scan, ivf_topk_device
from arxiv_rag_tpu_torch.ops.topk import flat_search
from arxiv_rag_tpu_torch.parallel.mesh import DeviceMesh, replicate
from arxiv_rag_tpu_torch.parallel.search import merge_shards


def partition_clusters(offsets: np.ndarray, nd: int) -> np.ndarray:
    """[nd+1] cluster cut points splitting the clusters into contiguous
    ranges of near-equal ROW counts (``offsets``: IVFIndex.offsets)."""
    total = int(offsets[-1])
    # shard s ideally starts at s/nd of the rows; searchsorted on the
    # cluster prefix sums snaps that to a cluster edge
    targets = (np.arange(1, nd) * total) // nd
    cuts = np.searchsorted(offsets, targets, side="left")
    cuts = np.concatenate([[0], cuts, [offsets.shape[0] - 1]])
    return np.maximum.accumulate(cuts).astype(np.int64)


@dataclass
class ShardedIVF:
    """Cluster-partitioned layout of ``ivf`` for an ``nd``-entry mesh;
    ``search`` returns dense row ids, as ``IVFIndex.search`` does."""

    ivf: IVFIndex
    nd: int
    cluster_cuts: np.ndarray  # [nd+1] cluster ranges per shard
    row_starts: np.ndarray  # [nd+1] IVF-row boundaries per shard
    rows_pad: int  # per-shard rows, padded (common to the shards)
    dead_block: int  # shard-local dead block id (common)
    _device: dict = field(default_factory=dict, repr=False)

    @property
    def block_rows(self) -> int:
        return self.ivf.block_rows

    @property
    def blocks_per_shard(self) -> int:  # the dead block included
        return self.rows_pad // self.block_rows

    @classmethod
    def build(cls, ivf: IVFIndex, nd: int) -> "ShardedIVF":
        br = ivf.block_rows
        cuts = partition_clusters(ivf.offsets, nd)
        row_starts = ivf.offsets[cuts].astype(np.int64)
        # the widest shard tail-aligned to a block, plus one dead block
        rows_pad = int(-(-np.diff(row_starts).max() // br) * br + br)
        return cls(ivf=ivf, nd=nd, cluster_cuts=cuts, row_starts=row_starts,
                   rows_pad=rows_pad, dead_block=rows_pad // br - 1)

    # -- planning ---------------------------------------------------------

    def plan_blocks(self, cluster_ids: np.ndarray, q_block: int) -> np.ndarray:
        """[nd, tiles, width] shard-LOCAL block tables (ascending ids,
        dead-padded, width a power of two, at least 8, shared by the
        shards)."""
        qn = cluster_ids.shape[0]
        if qn % q_block:
            raise ValueError(f"{qn} probe rows not a multiple of q_block {q_block}")
        br, off = self.block_rows, self.ivf.offsets
        cuts, starts = self.cluster_cuts, self.row_starts
        lists: list[list[np.ndarray]] = [[] for _ in range(self.nd)]
        for t in range(qn // q_block):
            cl = np.unique(cluster_ids[t * q_block : (t + 1) * q_block])
            cl = cl[(cl >= 0) & (cl < self.ivf.n_clusters)]
            cl = cl[off[cl + 1] > off[cl]]  # empty clusters cover nothing
            shard_of = np.searchsorted(cuts, cl, side="right") - 1
            for s in range(self.nd):
                cs = cl[shard_of == s]
                lo = (off[cs] - starts[s]) // br
                hi = -(-(off[cs + 1] - starts[s]) // br)
                blocks = np.unique(np.concatenate(
                    [np.arange(a, b) for a, b in zip(lo, hi)] or [np.zeros(0, np.int64)]))
                lists[s].append(blocks.astype(np.int32))
        width = max(1, max(len(b) for per in lists for b in per))
        bucket = 8
        while bucket < width:
            bucket *= 2
        bucket = max(min(bucket, max(1, self.blocks_per_shard - 1)), width)
        table = np.full((self.nd, qn // q_block, bucket), self.dead_block, np.int32)
        for s in range(self.nd):
            for t, blocks in enumerate(lists[s]):
                table[s, t, : len(blocks)] = blocks
        return table

    def _shard_cluster_blocks(self) -> np.ndarray:
        """[nd, C, maxb] int32: each cluster's covering SHARD-LOCAL block
        ids on its home shard, dead elsewhere and for empty clusters (the
        device planner's expansion table, as ``cluster_block_table``)."""
        off, cuts, starts = self.ivf.offsets, self.cluster_cuts, self.row_starts
        br, nc = self.block_rows, self.ivf.n_clusters
        home = np.searchsorted(cuts, np.arange(nc), side="right") - 1
        lo = (off[:-1] - starts[home]) // br
        hi = -(-(off[1:] - starts[home]) // br)
        counts = np.where(off[1:] > off[:-1], np.maximum(hi - lo, 0), 0)
        maxb = max(1, int(counts.max()))
        steps = np.arange(maxb, dtype=np.int64)[None, :]
        blocks = np.where(steps < counts[:, None], lo[:, None] + steps, self.dead_block)
        table = np.full((self.nd, nc, maxb), self.dead_block, np.int64)
        table[home, np.arange(nc)] = blocks
        return table.astype(np.int32)

    # -- device -----------------------------------------------------------

    def to_device(self, mesh: DeviceMesh) -> None:
        """Each local shard's rows (scales and masks too), its expansion
        table, row start and row count on its mesh device; the centroids on
        every local device. Placed once per mesh."""
        if mesh.size != self.nd:
            raise ValueError(f"layout built for {self.nd} shards, mesh has {mesh.size}")
        if self._device.get("mesh") == mesh:
            return
        ivf, d = self.ivf, self.ivf.values.shape[1]
        cb = self._shard_cluster_blocks()
        shards: list = [None] * mesh.size
        for s in mesh.local:
            dev = mesh.devices[s]
            lo, hi = int(self.row_starts[s]), int(self.row_starts[s + 1])

            def slab(t, shape, dtype):
                out = torch.zeros(shape, dtype=dtype, device=dev)
                out[: hi - lo].copy_(t[lo:hi])
                return out

            shards[s] = {
                "values": slab(ivf.values, (self.rows_pad, d), ivf.values.dtype),
                "scales": None if ivf.scales is None
                else slab(ivf.scales, (self.rows_pad,), torch.float32),
                "masks": None if ivf.row_masks is None
                else slab(ivf.row_masks, (self.rows_pad,), torch.int32),
                "cb": torch.from_numpy(cb[s]).to(dev),
                "start": lo, "n_valid": hi - lo,
            }
        cents = replicate(np.asarray(ivf.centroids, np.float32), mesh)
        for s in mesh.local:
            shards[s]["centroids"] = cents[s]
        self._device = {"mesh": mesh, "shards": shards}

    def probe(self, queries: torch.Tensor, nprobe: int) -> np.ndarray:
        """[Q, nprobe] nearest-centroid ids, on the first local shard's
        device."""
        c = self._device["shards"][self._device["mesh"].local[0]]["centroids"]
        _, cids = flat_search(c, queries.to(c.device, torch.float32),
                              min(nprobe, self.ivf.n_clusters))
        return cids.cpu().numpy()

    # -- search -----------------------------------------------------------

    def search(self, queries, k: int, mesh: DeviceMesh, *, nprobe: int, q_block: int = 8,
               query_mask=None, plan: str = "host") -> tuple[np.ndarray, np.ndarray]:
        """Mesh-wide cluster-pruned top-k: (scores [Q, k], dense row ids
        [Q, k]; unfilled slots -1). ``plan="device"`` probes and plans on
        each shard's device with no host sync, over the same rows per
        shard as the host planner, so the results equal its."""
        if plan not in ("host", "device"):
            raise ValueError(f"unknown plan mode {plan!r}")
        self.to_device(mesh)
        qn = queries.shape[0]
        q, qm = self.ivf._pad(queries, query_mask, q_block, mesh.home)
        if qm is not None and self.ivf.row_masks is None:
            raise ValueError("IVF index has no row masks; rebuild with categories")
        tables = None
        if plan == "host":
            tables = self.plan_blocks(self.probe(q, nprobe), q_block)
        qs = replicate(q, mesh)
        qms = replicate(qm, mesh) if qm is not None else [None] * mesh.size
        vals: list = [None] * mesh.size
        gids: list = [None] * mesh.size
        for s in mesh.local:
            shard = self._device["shards"][s]
            kw = dict(n_valid=shard["n_valid"], block_rows=self.block_rows, q_block=q_block,
                      scales=shard["scales"])
            if qm is not None:
                kw.update(row_masks=shard["masks"], query_mask=qms[s])
            if tables is None:
                v, i = ivf_topk_device(shard["values"], shard["cb"], shard["centroids"], qs[s],
                                       k, nprobe=nprobe, **kw)
            else:
                v, i = _table_scan(shard["values"], tables[s], qs[s], k, **kw)
            vals[s] = v
            gids[s] = torch.where(i >= 0, i + shard["start"], torch.full_like(i, -1))
        mv, mg = merge_shards(vals, gids, mesh)
        return mv[:qn].cpu().numpy(), self.ivf._rows(mg[:qn].cpu().numpy())

"""IVF index: a cluster-pruned layout over the dense store.

The port of ``arxiv_rag_tpu/index/ivf.py`` (:67-525). Rows are permuted
cluster-contiguously with no per-cluster padding (a probed cluster's
covering blocks may hold a neighbour's rows, which only adds
candidates); ``perm`` maps IVF row → dense row, so the engine's row
space never changes. The permuted values are built on the device where
the dense values lie, never through a host round trip.

Persistence is the reference's delta: ``<index dir>/ivf/centroids.npy``,
``perm.npy``, ``offsets.npy`` and ``meta.json``; load re-permutes the
dense rows. A delta saved by either package loads in the other.

Each query tile of ``q_block`` queries scans the union of its queries'
probed clusters' blocks, so IVF pays off at small tiles (q_block 8) and
many clusters; the flat scan stays the exact default.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from arxiv_rag_tpu_torch.device import default_device
from arxiv_rag_tpu_torch.logging_utils import get_logger
from arxiv_rag_tpu_torch.ops.ivf import (
    cluster_block_table,
    ivf_topk,
    ivf_topk_device,
    ivf_topk_int8,
    ivf_topk_int8_masked,
    ivf_topk_masked,
    pad_index_for_ivf,
)
from arxiv_rag_tpu_torch.ops.kmeans import assign_clusters, spherical_kmeans
from arxiv_rag_tpu_torch.ops.topk import flat_search

log = get_logger("ivf")

IVF_DIR = "ivf"


def _dense_rows_f32(dense, sl, dev) -> torch.Tensor:
    """fp32 rows of a DenseIndex slice on ``dev`` (int8 dequantized)."""
    chunk = dense.values[sl].to(dev, torch.float32)
    if dense.dtype == "int8":
        return chunk * dense.scales[sl].to(dev, torch.float32)[:, None]
    return chunk


def _dense_masks(dense, dev) -> torch.Tensor | None:
    if dense.row_masks is None:
        return None
    bits = np.ascontiguousarray(dense.row_masks, np.uint32).view(np.int32)
    return torch.from_numpy(bits).to(dev)


def _layout(dense, perm: np.ndarray, block_rows: int, dev):
    """(values, scales, row_masks, dead block) in IVF row order, padded."""
    p = torch.from_numpy(perm).to(dev)
    values = dense.values.to(dev)[p]
    scales = None if dense.scales is None else dense.scales.to(dev, torch.float32)[p]
    masks = _dense_masks(dense, dev)
    return pad_index_for_ivf(values, block_rows, scales=scales,
                             row_masks=None if masks is None else masks[p])


@dataclass
class IVFIndex:
    centroids: np.ndarray  # [C, D] f32, L2-normalized
    perm: np.ndarray  # [N] int64: IVF row -> dense row
    offsets: np.ndarray  # [C+1] int64 cluster row ranges (IVF order)
    block_rows: int
    dtype: str  # the dense index's: float32 | bfloat16 | int8
    values: torch.Tensor  # [N_pad, D] reordered + tail-aligned + dead block
    scales: torch.Tensor | None  # [N_pad] fp32 for int8
    row_masks: torch.Tensor | None  # [N_pad] int32 bits of the uint32 masks
    n_valid: int
    dead_block: int

    # set by to_device()
    _device_centroids: torch.Tensor | None = None
    _device_cb: torch.Tensor | None = None  # [C, maxb] cluster -> block table

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_blocks(self) -> int:  # includes the dead block
        return self.values.shape[0] // self.block_rows

    # -- build -----------------------------------------------------------

    @classmethod
    def build(
        cls,
        dense,
        n_clusters: int,
        *,
        block_rows: int = 1024,
        iters: int = 10,
        seed: int = 0,
        sample_rows: int | None = 262144,
        assign_batch: int = 262144,
        centroids: np.ndarray | None = None,
        assignments: np.ndarray | None = None,
        device=None,
    ) -> "IVFIndex":
        """Train centroids, assign every row, permute cluster-contiguous,
        all on ``device`` (the card by default). ``centroids`` and
        ``assignments`` may be given precomputed, as in the reference."""
        dev = default_device(device)
        n = dense.num_rows
        if n_clusters < 2 or n_clusters > n:
            raise ValueError(f"n_clusters {n_clusters} out of range for {n} rows")
        rng = np.random.default_rng(seed)
        if centroids is None:
            t_rows = min(n, sample_rows) if sample_rows else n
            t_idx = torch.from_numpy(np.sort(rng.choice(n, size=t_rows, replace=False)))
            cents = spherical_kmeans(_dense_rows_f32(dense, t_idx, dev), n_clusters,
                                     iters=iters, seed=seed, sample_rows=None)
        else:
            cents = torch.from_numpy(np.array(centroids, np.float32)).to(dev)
            if cents.shape[0] != n_clusters:
                raise ValueError(f"supplied centroids have {cents.shape[0]} rows, "
                                 f"expected n_clusters={n_clusters}")
        if assignments is None:
            assign = torch.cat([
                assign_clusters(_dense_rows_f32(dense, slice(s, min(s + assign_batch, n)), dev),
                                cents)
                for s in range(0, n, assign_batch)])
        else:
            assign = torch.from_numpy(np.array(assignments, np.int32)).to(dev)
            if assign.shape != (n,):
                raise ValueError(f"assignments shape {tuple(assign.shape)} != ({n},)")
        order = torch.argsort(assign, stable=True)
        counts = torch.bincount(assign, minlength=n_clusters).cpu().numpy()
        offsets = np.zeros((n_clusters + 1,), np.int64)
        np.cumsum(counts, out=offsets[1:])
        perm = order.cpu().numpy().astype(np.int64)
        values, scales, row_masks, dead = _layout(dense, perm, block_rows, dev)
        log.info("built IVF: %d rows, %d clusters (min/median/max %d/%d/%d rows), "
                 "%d blocks of %d", n, n_clusters, counts.min(), int(np.median(counts)),
                 counts.max(), values.shape[0] // block_rows, block_rows)
        return cls(centroids=cents.cpu().numpy(), perm=perm, offsets=offsets,
                   block_rows=block_rows, dtype=dense.dtype, values=values, scales=scales,
                   row_masks=row_masks, n_valid=n, dead_block=dead)

    # -- persistence -----------------------------------------------------

    def save(self, directory: str | Path) -> None:
        """Write the delta (centroids/perm/offsets + meta) under
        ``<index dir>/ivf/``; the reordered values are rebuilt at load."""
        d = Path(directory) / IVF_DIR
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / "centroids.npy", np.asarray(self.centroids, np.float32))
        np.save(d / "perm.npy", np.asarray(self.perm, np.int64))
        np.save(d / "offsets.npy", np.asarray(self.offsets, np.int64))
        meta = {"block_rows": self.block_rows, "n_clusters": self.n_clusters,
                "dtype": self.dtype, "n_valid": self.n_valid}
        tmp = d / "meta.json.tmp"
        tmp.write_text(json.dumps(meta, indent=1))
        tmp.replace(d / "meta.json")
        log.info("saved IVF delta (%d clusters) to %s", self.n_clusters, d)

    @classmethod
    def load(cls, directory: str | Path, dense, device=None) -> "IVFIndex":
        """Load the delta and re-permute ``dense``'s rows on ``device``
        (the card by default)."""
        d = Path(directory) / IVF_DIR
        meta = json.loads((d / "meta.json").read_text())
        if meta["dtype"] != dense.dtype:
            raise ValueError(f"IVF delta was built for dtype {meta['dtype']}, dense index "
                             f"is {dense.dtype}; rebuild with `index --ivf-clusters`")
        if meta["n_valid"] != dense.num_rows:
            raise ValueError(f"IVF delta covers {meta['n_valid']} rows, dense index has "
                             f"{dense.num_rows}; rebuild")
        perm = np.load(d / "perm.npy").astype(np.int64)
        block_rows = int(meta["block_rows"])
        values, scales, row_masks, dead = _layout(dense, perm, block_rows,
                                                  default_device(device))
        return cls(centroids=np.load(d / "centroids.npy"), perm=perm,
                   offsets=np.load(d / "offsets.npy"), block_rows=block_rows,
                   dtype=dense.dtype, values=values, scales=scales, row_masks=row_masks,
                   n_valid=int(meta["n_valid"]), dead_block=dead)

    @staticmethod
    def exists(directory: str | Path) -> bool:
        return (Path(directory) / IVF_DIR / "meta.json").exists()

    @classmethod
    def extend(cls, directory: str | Path, dense, *, assign_batch: int = 262144,
               device=None) -> "IVFIndex":
        """Refresh the saved delta after ``append_index`` grew ``dense``:
        the trained centroids stay, the old rows keep the clusters that
        ``perm``/``offsets`` record (position p of ``perm`` lies in
        cluster c iff offsets[c] <= p < offsets[c+1]), only the new rows
        are assigned, on ``device`` (the card by default), in the batches
        a full build assigns them in; the layout is rebuilt there and
        saved. The result is a full ``build`` with the same centroids on
        that device, bit for bit (the same assignments, stably sorted)."""
        d = Path(directory) / IVF_DIR
        meta = json.loads((d / "meta.json").read_text())
        if meta["dtype"] != dense.dtype:
            raise ValueError(f"IVF delta was built for dtype {meta['dtype']}, dense index "
                             f"is {dense.dtype}; rebuild with `index --ivf-clusters`")
        old_n, new_n = int(meta["n_valid"]), dense.num_rows
        if new_n < old_n:
            raise ValueError(f"dense index shrank ({new_n} rows < IVF's {old_n}); rebuild")
        dev = default_device(device)
        perm = np.load(d / "perm.npy")
        offsets = np.load(d / "offsets.npy")
        centroids = np.load(d / "centroids.npy")
        n_clusters = centroids.shape[0]
        assign = np.empty((new_n,), np.int32)
        assign[perm] = np.repeat(np.arange(n_clusters, dtype=np.int32), np.diff(offsets))
        cents = torch.from_numpy(np.array(centroids, np.float32)).to(dev)
        # the batches a full build assigns in, from the one holding the first
        # new row: each row's scores come from the same product shapes
        for start in range(old_n - old_n % assign_batch, new_n, assign_batch):
            stop = min(start + assign_batch, new_n)
            got = assign_clusters(_dense_rows_f32(dense, slice(start, stop), dev), cents)
            assign[max(start, old_n):stop] = got[max(start, old_n) - start:].cpu().numpy()
        ivf = cls.build(dense, n_clusters, block_rows=int(meta["block_rows"]),
                        centroids=centroids, assignments=assign, device=dev)
        ivf.save(directory)
        log.info("extended IVF delta: %d -> %d rows (%d clusters)", old_n, new_n, n_clusters)
        return ivf

    # -- device ----------------------------------------------------------

    def to_device(self, device=None) -> "IVFIndex":
        """Place the layout, the centroids and the cluster→block table on
        ``device`` (the card by default)."""
        dev = default_device(device)
        self.values = self.values.to(dev)
        if self.scales is not None:
            self.scales = self.scales.to(dev)
        if self.row_masks is not None:
            self.row_masks = self.row_masks.to(dev)
        self._device_centroids = torch.from_numpy(
            np.array(self.centroids, np.float32)).to(dev)
        self._device_cb = torch.from_numpy(
            cluster_block_table(self.offsets, self.block_rows, self.dead_block)).to(dev)
        return self

    def _placed(self) -> torch.device:
        if self._device_cb is None:
            self.to_device(self.values.device)
        return self.values.device

    # -- probe planning --------------------------------------------------

    def probe(self, queries, nprobe: int) -> np.ndarray:
        """[Q, nprobe] nearest-centroid ids (fp32 scores, stable top-k)."""
        dev = self._placed()
        q = torch.as_tensor(queries, dtype=torch.float32).to(dev)
        _, cids = flat_search(self._device_centroids, q, min(nprobe, self.n_clusters))
        return cids.cpu().numpy()

    def plan_blocks(self, cluster_ids: np.ndarray, q_block: int) -> np.ndarray:
        """Per-tile block table: the union of the tile's probed clusters'
        covering blocks, ascending, dead-padded, width bucketed to a power
        of two (at least 8, at most the real block count)."""
        qn = cluster_ids.shape[0]
        if qn % q_block:
            raise ValueError(f"{qn} probe rows not a multiple of q_block {q_block}")
        br, off = self.block_rows, self.offsets
        lists = []
        for t in range(qn // q_block):
            cl = np.unique(cluster_ids[t * q_block : (t + 1) * q_block])
            cl = cl[(cl >= 0) & (cl < self.n_clusters)]
            cl = cl[off[cl + 1] > off[cl]]  # empty clusters cover nothing
            starts, ends = off[cl] // br, -(-off[cl + 1] // br)
            blocks = np.unique(np.concatenate(
                [np.arange(s, e) for s, e in zip(starts, ends)] or [np.zeros(0, np.int64)]))
            lists.append(blocks.astype(np.int32))
        width = max(1, max(len(b) for b in lists))
        bucket = 8
        while bucket < width:
            bucket *= 2
        bucket = max(min(bucket, max(1, self.n_blocks - 1)), width)
        table = np.full((len(lists), bucket), self.dead_block, np.int32)
        for t, blocks in enumerate(lists):
            table[t, : len(blocks)] = blocks
        return table

    # -- search ----------------------------------------------------------

    def _pad(self, queries, query_mask, q_block: int, dev):
        """Queries (fp32) and query mask (int32 bits) on ``dev``, padded to
        a ``q_block`` multiple by repeating the last row, so pad tiles
        share its probes. A mask that is a tensor already stays on the
        device (no copy from the host)."""
        q = torch.as_tensor(queries, dtype=torch.float32).to(dev)
        qm = None
        if query_mask is not None:
            if isinstance(query_mask, torch.Tensor):
                qm = query_mask.to(dev, torch.int32)
            else:
                bits = np.asarray(query_mask).astype(np.uint32).view(np.int32)
                qm = torch.from_numpy(np.ascontiguousarray(bits)).to(dev)
        pad = (-q.shape[0]) % q_block
        if pad and q.shape[0]:
            q = torch.cat([q, q[-1:].expand(pad, -1)])
            if qm is not None:
                qm = torch.cat([qm, qm[-1:].expand(pad)])
        return q, qm

    def _rows(self, local: np.ndarray) -> np.ndarray:
        """LOCAL ids → dense rows; -1 stays -1."""
        return np.where(local >= 0, self.perm[np.clip(local, 0, self.n_valid - 1)],
                        np.int64(-1))

    def search(self, queries, k: int, *, nprobe: int, q_block: int = 8,
               query_mask=None, plan: str = "host") -> tuple[np.ndarray, np.ndarray]:
        """Cluster-pruned top-k: (scores [Q,k], dense rows [Q,k]; unfilled
        slots -1). ``query_mask`` ([Q] uint32 bits) filters exactly inside
        the probed blocks. ``plan="device"`` probes, plans and scans in one
        dispatch; it covers the same rows, so its results equal the host
        planner's."""
        dev = self._placed()
        qn = queries.shape[0]
        q, qm = self._pad(queries, query_mask, q_block, dev)
        if plan == "device":
            vals, local = self._search_device(q, k, nprobe=nprobe, q_block=q_block,
                                              query_mask=qm)
        elif plan == "host":
            table = self.plan_blocks(self.probe(q, nprobe), q_block)
            vals, local = self._search_table(q, table, k, q_block=q_block, query_mask=qm)
        else:
            raise ValueError(f"unknown plan mode {plan!r}")
        return vals[:qn].cpu().numpy(), self._rows(local[:qn].cpu().numpy())

    def search_dispatch(self, queries, k: int, *, nprobe: int, q_block: int = 8,
                        query_mask=None):
        """Device-planned search without fetching: returns ``finish() ->
        (scores, dense rows)``. Queries (and a tensor query mask) on the
        device stay there: nothing here waits for the device."""
        dev = self._placed()
        qn = queries.shape[0]
        q, qm = self._pad(queries, query_mask, q_block, dev)
        vals, local = self._search_device(q, k, nprobe=nprobe, q_block=q_block,
                                          query_mask=qm)

        def finish() -> tuple[np.ndarray, np.ndarray]:
            return vals[:qn].cpu().numpy(), self._rows(local[:qn].cpu().numpy())

        return finish

    def _mask_kw(self, query_mask) -> dict:
        if query_mask is None:
            return {}
        if self.row_masks is None:
            raise ValueError("IVF index has no row masks; rebuild with categories")
        return {"row_masks": self.row_masks, "query_mask": query_mask}

    def _search_device(self, q, k, *, nprobe, q_block, query_mask=None):
        """One dispatch (K6); device tensors, LOCAL ids."""
        kw = self._mask_kw(query_mask)
        if self.dtype == "int8":
            kw["scales"] = self.scales
        return ivf_topk_device(self.values, self._device_cb, self._device_centroids, q, k,
                               nprobe=nprobe, n_valid=self.n_valid,
                               block_rows=self.block_rows, q_block=q_block, **kw)

    def _search_table(self, q, table, k, *, q_block, query_mask=None):
        """The pruned scan (K5) for a prepared block table; device tensors,
        LOCAL ids."""
        kw = dict(n_valid=self.n_valid, block_rows=self.block_rows, q_block=q_block)
        mask = self._mask_kw(query_mask)
        if mask:
            if self.dtype == "int8":
                return ivf_topk_int8_masked(self.values, self.scales, mask["row_masks"],
                                            query_mask, table, q, k, **kw)
            return ivf_topk_masked(self.values, mask["row_masks"], query_mask, table, q,
                                   k, **kw)
        if self.dtype == "int8":
            return ivf_topk_int8(self.values, self.scales, table, q, k, **kw)
        return ivf_topk(self.values, table, q, k, **kw)

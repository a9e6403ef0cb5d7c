"""Query-time search engine: the dense, category-filtered and IVF routes.

The port of ``arxiv_rag_tpu/search/engine.py``'s single-device routes:
encode → scan → hydrate. Routing follows the reference:

- the query batch pads to the buckets 8/32/64/128, then multiples of
  128, by repeating the last row (``:311-328``, ``:433-441``);
- with an IVF index attached and ``nprobe > 0`` (argument, else
  ``cfg.nprobe``) and k ≤ 128, the cluster-pruned scan (``:337-387``):
  ``cfg.ivf_plan = "device"`` (the default) is one dispatch with no host
  sync (K6) whose ``finish`` maps local ids through ``perm``; "host"
  probes, plans the block tables on the host and scans (K5);
- k ≤ 128 goes to the fused kernels (``ops/fused_topk.py``): K1 for an
  f32/bf16 index, K2 s8s8 for an int8 index, and with ``categories`` the
  masked forms K4 (``_single_chip`` :472-525); k > 128 goes to the plain
  scans, masked the same way;
- ``categories=[]`` matches no row and returns empty lists;
- results hydrate to ``SearchResult`` rows and scores (no corpus).

Hybrid BM25, rerank, corpus hydration and live reload belong to later
slices of the port: asking for any of them raises
``NotImplementedError`` rather than answering without it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from arxiv_rag_tpu_torch.config import RetrievalConfig
from arxiv_rag_tpu_torch.index.store import DenseIndex
from arxiv_rag_tpu_torch.logging_utils import METRICS
from arxiv_rag_tpu_torch.ops.fused_topk import (
    K_MAX,
    fused_topk,
    fused_topk_int8,
    fused_topk_int8_masked,
    fused_topk_masked,
)
from arxiv_rag_tpu_torch.ops.quant import int8_search
from arxiv_rag_tpu_torch.ops.topk import masked_flat_search


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to arxiv_rag_tpu_torch yet (later slice: {slice_name}); "
        "use arxiv_rag_tpu for it"
    )


@dataclass
class SearchResult:
    row: int
    score: float
    chunk_id: str = ""
    paper_id: str = ""
    category: str = ""
    section: str = ""
    page: int = 0
    text: str = ""
    extras: dict = field(default_factory=dict)


class SearchEngine:
    """Dense retrieval over a device-resident index. The index is placed
    on ``device`` (the card by default) unless it already is; an IVF
    index (``index/ivf.py``) is placed beside it."""

    def __init__(
        self,
        index: DenseIndex,
        embedder=None,
        corpus=None,
        cfg: RetrievalConfig = RetrievalConfig(),
        bm25=None,
        reranker=None,
        ivf=None,
        device=None,
    ) -> None:
        if corpus is not None:
            raise _later("corpus hydration", "prepare_reload/append_index/corpus hydration")
        if bm25 is not None:
            raise _later("hybrid BM25 retrieval", "hybrid BM25 + cross-encoder")
        if reranker is not None:
            raise _later("cross-encoder rerank", "hybrid BM25 + cross-encoder")
        self.index = index
        self.embedder = embedder
        self.cfg = cfg
        if index._device_values is None:
            index.to_device(device)
        self.ivf = ivf
        if ivf is not None and ivf._device_cb is None:
            ivf.to_device(index._device_values.device)

    def prepare_reload(self, index_dir, **kwargs):
        raise _later("live index reload", "prepare_reload/append_index/corpus hydration")

    # -- dense ------------------------------------------------------------

    def search_embeddings(
        self,
        query_embs,
        k: int | None = None,
        categories: Sequence[str] | None = None,
        nprobe: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(scores [Q,k], index rows [Q,k]) for pre-embedded queries."""
        return self.search_embeddings_dispatch(query_embs, k, categories, nprobe=nprobe)()

    def search_embeddings_dispatch(
        self,
        query_embs,
        k: int | None = None,
        categories: Sequence[str] | None = None,
        n_real: int | None = None,
        nprobe: int | None = None,
    ):
        """Launch the scan and return ``finish() -> (scores, rows)``, which
        copies the results to the host. ``query_embs`` is numpy or a
        tensor, possibly padded already (``n_real`` real rows)."""
        k = k or self.cfg.top_k
        idx = self.index
        dev = idx._device_values.device
        qn_in = query_embs.shape[0]
        qn_real = qn_in if n_real is None else n_real
        qn_pad = self._query_bucket(qn_in)
        if isinstance(query_embs, np.ndarray):
            q = torch.from_numpy(np.ascontiguousarray(query_embs, np.float32)).to(dev)
        else:
            q = query_embs.to(dev, torch.float32)
        if qn_pad != qn_in:
            # pad rows repeat the last query (zeros for an empty batch), so
            # on the IVF route pad tiles share the last query's probes;
            # results trim to the real count at finish
            fill = (q[-1:].expand(qn_pad - qn_in, -1) if qn_in
                    else q.new_zeros((qn_pad, q.shape[1])))
            q = torch.cat([q, fill])
        qmask = None if categories is None else self._qmask(categories, qn_pad, dev)
        np_probe = self.cfg.nprobe if nprobe is None else nprobe
        # k > 128 exceeds the fused kernels' candidate lists (IVF's too):
        # it falls through to the flat route's plain scan
        if self.ivf is not None and np_probe > 0 and k <= K_MAX:
            with METRICS.timer("search.ivf"):
                if self.cfg.ivf_plan == "device":
                    fin = self.ivf.search_dispatch(q, k, nprobe=np_probe,
                                                   q_block=self.cfg.ivf_q_block,
                                                   query_mask=qmask)

                    def finish_ivf_dev() -> tuple[np.ndarray, np.ndarray]:
                        with METRICS.timer("search.fetch"):
                            v, r = fin()
                        return v[:qn_real], r[:qn_real]

                    return finish_ivf_dev
                ivals, irows = self.ivf.search(q, k, nprobe=np_probe,
                                               q_block=self.cfg.ivf_q_block,
                                               query_mask=qmask, plan=self.cfg.ivf_plan)

            def finish_ivf() -> tuple[np.ndarray, np.ndarray]:
                return ivals[:qn_real], irows[:qn_real]

            return finish_ivf
        with METRICS.timer("search.dense"):
            if k <= K_MAX:
                vals, rows = self._single_chip(q, k, qmask)
            else:
                vals, rows = self._plain(q, k, qmask)

        def finish() -> tuple[np.ndarray, np.ndarray]:
            with METRICS.timer("search.fetch"):
                return vals[:qn_real].cpu().numpy(), rows[:qn_real].cpu().numpy()

        return finish

    @staticmethod
    def _query_bucket(qn: int) -> int:
        for b in (8, 32, 64, 128):
            if qn <= b:
                return b
        return ((qn + 127) // 128) * 128

    def _qmask(self, categories: Sequence[str], qn: int, dev) -> torch.Tensor:
        """[qn] int32 query mask: the uint32 category bits viewed as int32
        (category 31 sets the sign bit), filled on the device."""
        bits = np.uint32(self.index.category_mask(categories)).view(np.int32)
        return torch.full((qn,), int(bits), dtype=torch.int32, device=dev)

    def _row_masks(self) -> torch.Tensor:
        if self.index._device_masks is None:
            raise ValueError("category filter requested but index was built without "
                             "categories")
        return self.index._device_masks

    def _single_chip(self, q, k, qmask):
        """k ≤ 128: the fused kernels; with a query mask, their masked
        forms (the s8s8 one for an int8 index, as the reference)."""
        idx = self.index
        n_valid = idx._n_valid
        if qmask is None:
            if idx.dtype == "int8":
                return fused_topk_int8(idx._device_values, idx._device_scales, q, k,
                                       n_valid=n_valid)
            return fused_topk(idx._device_values, q, k, n_valid=n_valid)
        if idx.dtype == "int8":
            return fused_topk_int8_masked(idx._device_values, idx._device_scales,
                                          self._row_masks(), qmask, q, k, n_valid=n_valid)
        return fused_topk_masked(idx._device_values, self._row_masks(), qmask, q, k,
                                 n_valid=n_valid)

    def _plain(self, q, k, qmask):
        """k > 128: the unfused scans, padding rows (and filtered rows)
        masked out."""
        idx = self.index
        n_pad = idx._device_values.shape[0]
        valid = torch.arange(n_pad, device=q.device) < idx._n_valid
        if qmask is None:
            row_masks = valid.to(torch.int32)
            qmask = torch.ones((q.shape[0],), dtype=torch.int32, device=q.device)
        else:
            row_masks = torch.where(valid, self._row_masks(), 0)
        if idx.dtype == "int8":
            return int8_search(idx._device_values, idx._device_scales, q, k,
                               row_masks=row_masks, query_mask=qmask)
        return masked_flat_search(idx._device_values, row_masks, qmask, q, k)

    # -- text queries -------------------------------------------------------

    def search(
        self,
        queries: Sequence[str],
        k: int | None = None,
        categories: Sequence[str] | None = None,
        hybrid_alpha: float | None = None,
        nprobe: int | None = None,
    ) -> list[list[SearchResult]]:
        """encode → scan → hydrate; ``search_dispatch`` finished at once."""
        return self.search_dispatch(queries, k=k, categories=categories,
                                    hybrid_alpha=hybrid_alpha, nprobe=nprobe)()

    def search_dispatch(
        self,
        queries: Sequence[str],
        k: int | None = None,
        categories: Sequence[str] | None = None,
        hybrid_alpha: float | None = None,
        nprobe: int | None = None,
    ):
        """Encode and launch the scan now; ``finish()`` fetches and hydrates."""
        if self.embedder is None:
            raise RuntimeError("SearchEngine needs an embedder for text queries")
        if hybrid_alpha is not None and hybrid_alpha < 1.0:
            raise _later("hybrid BM25 retrieval", "hybrid BM25 + cross-encoder")
        queries = list(queries)
        qn = len(queries)
        with METRICS.timer("search.encode"):
            # one padded batch per window, handed over on the device; the
            # host path serves windows above the largest batch height
            handoff = self.embedder.encode_window_device(queries)
            if handoff is not None:
                query_embs, n_real = handoff
            else:
                query_embs, n_real = self.embedder.encode_texts(queries), qn
        fin = self.search_embeddings_dispatch(query_embs, k, categories, n_real=n_real,
                                              nprobe=nprobe)

        def finish() -> list[list[SearchResult]]:
            scores, rows = fin()
            return self._hydrate_window(scores, rows, qn)

        return finish

    # -- hydration ----------------------------------------------------------

    def _hydrate_window(self, scores, rows, qn) -> list[list[SearchResult]]:
        return [self._hydrate(scores[i], rows[i]) for i in range(qn)]

    def _hydrate(self, scores, rows) -> list[SearchResult]:
        """Rows and scores; empty slots and padding (-inf) are dropped."""
        return [
            SearchResult(row=int(r), score=float(s))
            for s, r in zip(scores.tolist(), rows.tolist())
            if r >= 0 and np.isfinite(s)
        ]

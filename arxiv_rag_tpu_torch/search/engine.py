"""Query-time search engine, dense route.

The port of the dense route of ``arxiv_rag_tpu/search/engine.py``:
encode → fused flat top-k → hydrate. Routing follows the reference:

- the query batch pads to the buckets 8/32/64/128, then multiples of
  128, by repeating the last row (``:311-328``, ``:433-441``);
- k ≤ 128 goes to the fused kernels (``ops/fused_topk.py``: K1 for an
  f32/bf16 index, K2 s8s8 for an int8 index); k > 128 goes to the plain
  scans (``:338-341``, ``:392``);
- results hydrate to ``SearchResult`` rows and scores (no corpus).

Hybrid BM25, rerank, IVF, category filters, corpus hydration and live
reload belong to later slices of the port: asking for any of them raises
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
from arxiv_rag_tpu_torch.ops.fused_topk import K_MAX, fused_topk, fused_topk_int8
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
    on ``device`` (the card by default) unless it already is."""

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
        if ivf is not None:
            raise _later("IVF retrieval", "IVF (K5, K6)")
        self.index = index
        self.embedder = embedder
        self.cfg = cfg
        if index._device_values is None:
            index.to_device(device)

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

    def _check_route(self, categories, nprobe) -> None:
        if categories is not None:
            raise _later("category filters", "category masks (K4)")
        if (self.cfg.nprobe if nprobe is None else nprobe) > 0:
            raise _later("IVF probing (nprobe > 0)", "IVF (K5, K6)")

    def search_embeddings_dispatch(
        self,
        query_embs,
        k: int | None = None,
        categories: Sequence[str] | None = None,
        n_real: int | None = None,
        nprobe: int | None = None,
    ):
        """Launch the dense scan and return ``finish() -> (scores, rows)``,
        which copies the results to the host. ``query_embs`` is numpy or a
        tensor, possibly padded already (``n_real`` real rows)."""
        self._check_route(categories, nprobe)
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
            # pad rows repeat the last query (zeros for an empty batch);
            # results trim to the real count at finish
            fill = (q[-1:].expand(qn_pad - qn_in, -1) if qn_in
                    else q.new_zeros((qn_pad, q.shape[1])))
            q = torch.cat([q, fill])
        n_valid = idx._n_valid
        with METRICS.timer("search.dense"):
            if k <= K_MAX:
                if idx.dtype == "int8":
                    vals, rows = self._single_chip(q, k)
                else:
                    vals, rows = fused_topk(idx._device_values, q, k, n_valid=n_valid)
            else:
                vals, rows = self._plain(q, k)

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

    def _single_chip(self, q, k):
        """Unmasked int8 scan: the s8s8 kernel."""
        idx = self.index
        return fused_topk_int8(idx._device_values, idx._device_scales, q, k,
                               n_valid=idx._n_valid)

    def _plain(self, q, k):
        """k > 128: the unfused scans, padding rows masked out."""
        idx = self.index
        n_pad = idx._device_values.shape[0]
        valid = (torch.arange(n_pad, device=q.device) < idx._n_valid).to(torch.int64)
        ones = torch.ones((q.shape[0],), dtype=torch.int64, device=q.device)
        if idx.dtype == "int8":
            return int8_search(idx._device_values, idx._device_scales, q, k,
                               row_masks=valid, query_mask=ones)
        return masked_flat_search(idx._device_values, valid, ones, q, k)

    # -- text queries -------------------------------------------------------

    def search(
        self,
        queries: Sequence[str],
        k: int | None = None,
        categories: Sequence[str] | None = None,
        hybrid_alpha: float | None = None,
        nprobe: int | None = None,
    ) -> list[list[SearchResult]]:
        """encode → dense scan → hydrate; ``search_dispatch`` finished at once."""
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
        self._check_route(categories, nprobe)
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
        fin = self.search_embeddings_dispatch(query_embs, k, n_real=n_real)

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

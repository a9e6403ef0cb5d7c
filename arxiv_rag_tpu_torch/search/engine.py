"""Query-time search engine: the dense, category-filtered, IVF and
hybrid routes, corpus hydration and the cross-encoder rerank.

The port of ``arxiv_rag_tpu/search/engine.py``: encode → scan (→ hybrid
merge) → hydrate (→ rerank). Routing follows the reference:

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
- an index row-sharded over a mesh (``DenseIndex.to_device(mesh=...)``)
  takes the sharded routes (``:349-358``, ``:394-411``): the queries on
  this process's first mesh device, ``parallel.sharded_topk`` (every
  kind, masked or not; k > 128 a plain scan per shard), or with an IVF
  index and ``nprobe > 0`` the cluster-partitioned
  ``parallel.ShardedIVF`` (built once per mesh, ``_sharded_ivf``
  :443-452; either plan), whose results return at once rather than from
  ``finish``; the single-device routes raise for a sharded index. On a
  mesh that spans processes each process scans its own shards and the
  lists gather across processes, so every rank must run the same
  searches in the same order;
- hybrid (a BM25 index attached and ``hybrid_alpha < 1``): the dense
  candidates and the BM25 candidates of the whole window (one native
  call), each min-max normalized per query, merged as
  alpha·dense + (1-alpha)·bm25 (``_hybrid_merge`` :668-724);
- with a corpus, results hydrate their chunk metadata and text: from
  one in-memory table for corpora up to 200,000 rows, else lazily
  through the corpus's row-group cache (``:726-856``);
- with a reranker, the cross-encoder rescores each query's top
  ``rerank_top_k`` hydrated candidates, the window's pairs capped at
  ``rerank_max_window_pairs`` (``_rerank_window`` :615-666).

Every mode dispatches the dense scan before ``finish``; the host stages
(BM25, merge, hydration, rerank) run inside ``finish``.

Live reload (``prepare_reload``, ``:123-270``): a grown or rebuilt index
is loaded, placed (on this engine's device, or sharded over its mesh:
on a mesh that spans processes each process re-places its own shards)
and warmed on a shadow engine while this one serves; the returned
``swap`` re-points the engine with no IO. Unlike the reference, a failed
warm raises: on the card it is a kernel that failed on the new shapes,
and the old index goes on serving.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from arxiv_rag_tpu_torch.config import RetrievalConfig
from arxiv_rag_tpu_torch.index.store import DenseIndex
from arxiv_rag_tpu_torch.logging_utils import METRICS, get_logger
from arxiv_rag_tpu_torch.ops.fused_topk import (
    K_MAX,
    fused_topk,
    fused_topk_int8,
    fused_topk_int8_masked,
    fused_topk_masked,
)
from arxiv_rag_tpu_torch.ops.quant import int8_search
from arxiv_rag_tpu_torch.ops.topk import masked_flat_search
from arxiv_rag_tpu_torch.parallel import ShardedIVF, sharded_topk
from arxiv_rag_tpu_torch.search.bm25 import BM25Index

log = get_logger("search")


def bm25_for_index(index: DenseIndex, corpus) -> BM25Index:
    """The BM25 side of hybrid retrieval, in INDEX row order.

    The dense index may cover a filtered subset of the corpus, so BM25
    built over ``corpus.texts()`` would score in another row space than
    the dense scan. Corpus texts are joined through ``index.chunk_ids``
    when present; otherwise the corpus must have one chunk per index
    row."""
    if index.chunk_ids is not None:
        table = corpus.read_all(columns=["chunk_id", "text"])
        by_id = dict(
            zip(table.column("chunk_id").to_pylist(), table.column("text").to_pylist())
        )
        missing = [cid for cid in index.chunk_ids if cid not in by_id]
        if missing:
            raise ValueError(
                f"{len(missing)} index chunk_ids missing from corpus "
                f"(first: {missing[0]!r}) — wrong --corpus for this index?"
            )
        texts = [by_id[cid] for cid in index.chunk_ids]
    else:
        texts = corpus.texts()
        if len(texts) != index.num_rows:
            raise ValueError(
                f"corpus has {len(texts)} chunks but index has {index.num_rows} "
                "rows and no chunk_ids to join through — rebuild the index with "
                "chunk_ids or use the matching corpus"
            )
    return BM25Index.build(texts)


def _release_device(holder, fields: Sequence[str]) -> None:
    """Drop ``holder``'s references to its device tensors (a swapped-out
    index or IVF; ``None`` is left alone)."""
    if holder is None:
        return
    for f in fields:
        setattr(holder, f, None)


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
    """Retrieval over a device-resident index. The index is placed on
    ``device`` (the card by default) unless it already is; an IVF index
    (``index/ivf.py``) is placed beside it. ``corpus`` (a
    ``store.CorpusReader`` or an object with its ``read_all`` /
    ``take_rows`` contract) hydrates results, ``bm25`` (built in index
    row order: ``bm25_for_index``) enables hybrid retrieval and
    ``reranker`` (``search/rerank.py``) the cross-encoder."""

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
        if bm25 is not None and bm25.num_docs != index.num_rows:
            raise ValueError(
                f"bm25 has {bm25.num_docs} docs but index has {index.num_rows} "
                "rows; hybrid merge requires BM25 built in index row order "
                "(use bm25_for_index)"
            )
        self.index = index
        self.embedder = embedder
        self.corpus = corpus
        self.cfg = cfg
        self.bm25 = bm25
        self.reranker = reranker
        if index._device_values is None and index._mesh is None:
            index.to_device(device)
        self.ivf = ivf
        # on a mesh the IVF serves through its sharded layout (_sharded_ivf)
        if ivf is not None and ivf._device_cb is None and index._mesh is None:
            ivf.to_device(index._device_values.device)
        self._sharded_ivf_cache = None
        # hydration: small corpora from one in-memory table, large ones
        # lazily through the corpus's row-group cache; ``lazy_hydration``
        # forces either mode
        self.lazy_hydration: bool | None = None
        self._meta_cache: dict | None = None
        self._meta_by_id: dict | None = None
        self._row_map = None  # index row -> corpus row (lazy mode)

    # -- live reload --------------------------------------------------------

    def prepare_reload(
        self,
        index_dir,
        *,
        corpus_dir=None,
        bm25_path: str | None = None,
        cache_bytes: int | None = None,
        warm_buckets: tuple[int, ...] = (8, 32),
    ):
        """Load a grown or rebuilt index (its IVF delta, corpus and BM25
        side too) without touching this engine; returns ``swap() ->
        info``, which re-points the engine with no IO.

        Order: load on the host and check the dim and BM25's row count,
        then place on this engine's device, or shard over its mesh (old
        and new index coexist there until the swap: the reload's memory
        peak). The IVF delta is loaded only when the engine probes
        (``cfg.nprobe``, or an IVF attached): placed on the device, or on
        a mesh kept on the host for the shadow's sharded layout. A corpus
        is re-opened (``corpus_dir``, else this
        engine's corpus directory) so appended Parquet shards show; a
        corpus object without a directory is kept. A hybrid engine
        loads BM25 from ``bm25_path`` or rebuilds it in index row order.
        A shadow engine over the new state runs a search at every
        ``warm_buckets`` height for each k in use (and with every
        category, where the index has them) and the hydration warm; a
        failure there raises and nothing is swapped.

        ``swap`` runs where no window is in flight (``serve.py`` runs it
        on the dispatch thread behind a completion barrier). It adopts
        the shadow's warmed hydration state and drops this engine's last
        references to the old device tensors (and sharded layouts)."""
        from arxiv_rag_tpu_torch.index.ivf import IVFIndex

        mesh = self.index._mesh
        dev = self.index.placed_device
        new_idx = DenseIndex.load(index_dir)
        if new_idx.dim != self.index.dim:
            raise ValueError(f"reload index dim {new_idx.dim} != serving dim "
                             f"{self.index.dim}: wrong index for this embedder")
        new_corpus = None
        cdir = corpus_dir or getattr(self.corpus, "directory", None)
        if cdir is not None:
            from arxiv_rag_tpu_torch.store.corpus import CorpusReader

            cb = cache_bytes or getattr(self.corpus, "cache_bytes", 512 * 1024 * 1024)
            new_corpus = CorpusReader(cdir, cache_bytes=cb)
        elif self.corpus is not None:
            new_corpus = self.corpus  # not a store: nothing to re-open
        new_bm25 = None
        if bm25_path is not None:
            new_bm25 = BM25Index.load(bm25_path)
        elif self.bm25 is not None:
            if new_corpus is None:
                raise ValueError("hybrid engine reload needs a corpus to rebuild BM25 "
                                 "(or pass bm25_path)")
            new_bm25 = bm25_for_index(new_idx, new_corpus)
        if new_bm25 is not None and new_bm25.num_docs != new_idx.num_rows:
            raise ValueError(f"reload bm25 has {new_bm25.num_docs} docs but index has "
                             f"{new_idx.num_rows} rows: stale bm25_path?")
        if mesh is None:
            new_idx.to_device(dev)
        else:
            new_idx.to_device(mesh=mesh)
        new_ivf = None
        if (self.cfg.nprobe or self.ivf is not None) and IVFIndex.exists(index_dir):
            if mesh is None:
                new_ivf = IVFIndex.load(index_dir, new_idx, device=dev).to_device(dev)
            else:  # laid out on the host, from the host rows the index keeps
                new_ivf = IVFIndex.load(index_dir, new_idx, device="cpu")
        shadow = SearchEngine(new_idx, embedder=self.embedder, corpus=new_corpus,
                              cfg=self.cfg, bm25=new_bm25, reranker=self.reranker,
                              ivf=new_ivf, device=dev)
        shadow.lazy_hydration = self.lazy_hydration
        ks = {min(self.cfg.top_k, K_MAX)}
        if new_bm25 is not None or self.reranker is not None:
            ks.add(min(max(self.cfg.top_k, self.cfg.rerank_top_k), K_MAX))
        cat_sets = [None] + ([new_idx.categories] if new_idx.row_masks is not None else [])
        for qb in warm_buckets:
            for kk in sorted(ks):
                for cats in cat_sets:
                    shadow.search_embeddings(np.zeros((qb, new_idx.dim), np.float32), kk,
                                             categories=cats)
        if shadow._use_lazy_hydration():
            shadow.warm_hydration()
        else:
            shadow._load_meta()

        def swap() -> dict:
            old_idx, old_ivf, old_sharded = self.index, self.ivf, self._sharded_ivf_cache
            old_rows = old_idx.num_rows
            self.index, self.ivf = new_idx, new_ivf
            self._sharded_ivf_cache = shadow._sharded_ivf_cache
            if new_corpus is not None:
                self.corpus = new_corpus
            if new_bm25 is not None:
                self.bm25 = new_bm25
            self._row_map = shadow._row_map
            self._meta_cache = shadow._meta_cache
            self._meta_by_id = shadow._meta_by_id
            # the barrier guarantees nothing in flight reads the old tensors:
            # dropping the last references frees them now, not at some
            # later collection, which would prolong the old + new peak
            _release_device(old_idx, ("values", "scales", "_device_values",
                                      "_device_scales", "_device_masks", "_shard_values",
                                      "_shard_scales", "_shard_masks"))
            _release_device(old_ivf, ("values", "scales", "row_masks",
                                      "_device_centroids", "_device_cb"))
            if old_sharded is not None:
                old_sharded._device = {}
            log.info("reload swap: %d -> %d rows (%s%s)", old_rows, new_idx.num_rows,
                     new_idx.dtype, ", ivf" if new_ivf is not None else "")
            return {"rows": new_idx.num_rows, "dim": new_idx.dim, "dtype": new_idx.dtype,
                    "ivf": new_ivf is not None,
                    "bm25_rebuilt": new_bm25 is not None and bm25_path is None}

        return swap

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
        dev = idx.placed_device
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
                if idx._mesh is not None:
                    ivals, irows = self._sharded_ivf(idx._mesh).search(
                        q, k, idx._mesh, nprobe=np_probe, q_block=self.cfg.ivf_q_block,
                        query_mask=qmask, plan=self.cfg.ivf_plan)
                elif self.cfg.ivf_plan == "device":
                    fin = self.ivf.search_dispatch(q, k, nprobe=np_probe,
                                                   q_block=self.cfg.ivf_q_block,
                                                   query_mask=qmask)

                    def finish_ivf_dev() -> tuple[np.ndarray, np.ndarray]:
                        with METRICS.timer("search.fetch"):
                            v, r = fin()
                        return v[:qn_real], r[:qn_real]

                    return finish_ivf_dev
                else:
                    ivals, irows = self.ivf.search(q, k, nprobe=np_probe,
                                                   q_block=self.cfg.ivf_q_block,
                                                   query_mask=qmask, plan=self.cfg.ivf_plan)

            def finish_ivf() -> tuple[np.ndarray, np.ndarray]:
                return ivals[:qn_real], irows[:qn_real]

            return finish_ivf
        with METRICS.timer("search.dense"):
            if idx._mesh is not None:
                vals, rows = self._sharded(q, k, qmask)
            elif k <= K_MAX:
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

    def _single_device_index(self) -> DenseIndex:
        if self.index._mesh is not None:
            raise RuntimeError("the index is row-sharded over a mesh: it has no "
                               "single-device copy to scan")
        return self.index

    def _sharded(self, q, k, qmask):
        """The row-sharded index: ``parallel.sharded_topk`` (the fused
        kernels per shard, k > 128 a plain scan per shard), masked with a
        query mask, s8s8 for an int8 index."""
        idx = self.index
        kw = {}
        if qmask is not None:
            if idx._shard_masks is None:
                raise ValueError("category filter requested but index was built without "
                                 "categories")
            kw = {"row_masks": idx._shard_masks, "query_mask": qmask}
        if idx.dtype == "int8":
            kw["scales"] = idx._shard_scales
        return sharded_topk(idx._shard_values, q, k, idx._mesh, n_valid=idx._n_valid, **kw)

    def _sharded_ivf(self, mesh):
        """The IVF's cluster-partitioned layout for ``mesh``, built once
        (again if the mesh's size changes)."""
        if self._sharded_ivf_cache is None or self._sharded_ivf_cache.nd != mesh.size:
            self._sharded_ivf_cache = ShardedIVF.build(self.ivf, mesh.size)
        return self._sharded_ivf_cache

    def _single_chip(self, q, k, qmask):
        """k ≤ 128: the fused kernels; with a query mask, their masked
        forms (the s8s8 one for an int8 index, as the reference)."""
        idx = self._single_device_index()
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
        idx = self._single_device_index()
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
        """Encode and launch the dense scan now; ``finish()`` fetches,
        merges with BM25 (hybrid), hydrates and reranks. With a BM25
        index, ``hybrid_alpha=None`` means ``cfg.hybrid_alpha``; 1.0 (or
        no BM25 index) is pure dense."""
        if self.embedder is None:
            raise RuntimeError("SearchEngine needs an embedder for text queries")
        queries = list(queries)
        qn = len(queries)
        k = k or self.cfg.top_k
        if hybrid_alpha is None and self.bm25 is not None:
            hybrid_alpha = self.cfg.hybrid_alpha
        hybrid = (
            hybrid_alpha is not None and self.bm25 is not None and hybrid_alpha < 1.0
        )
        rerank = self.reranker is not None
        fetch_k = max(k, self.cfg.rerank_top_k) if rerank else k
        with METRICS.timer("search.encode"):
            # one padded batch per window, handed over on the device; the
            # host path serves windows above the largest batch height
            window = getattr(self.embedder, "encode_window_device", None)
            handoff = window(queries) if window is not None else None
            if handoff is not None:
                query_embs, n_real = handoff
            else:
                query_embs, n_real = self.embedder.encode_texts(queries), qn
        c = max(fetch_k, self.cfg.rerank_top_k) if hybrid else fetch_k
        fin = self.search_embeddings_dispatch(query_embs, c, categories, n_real=n_real,
                                              nprobe=nprobe)

        def finish() -> list[list[SearchResult]]:
            dvals, drows = fin()
            if hybrid:
                scores, rows = self._hybrid_merge(
                    queries, dvals, drows, fetch_k, categories, hybrid_alpha
                )
            else:
                scores, rows = dvals, drows
            hydrated = self._hydrate_window(scores, rows, qn)
            if rerank:
                hydrated = self._rerank_window(queries, hydrated, k)
            return hydrated

        return finish

    def _rerank_window(
        self, queries: Sequence[str], hydrated: list[list[SearchResult]], k: int
    ) -> list[list[SearchResult]]:
        """Cross-encoder pass over the whole window's candidate texts: all
        pairs flow through the reranker's bucketed stream in one call."""
        scored_lists = [[h for h in hits if h.text] for hits in hydrated]
        # admission control: over the cap, rerank depth degrades per
        # query to max(k, cap // queries) and results are flagged; every
        # query still reranks at least k pairs
        cap = self.cfg.rerank_max_window_pairs
        total_pairs = sum(len(sl) for sl in scored_lists)
        degraded = bool(cap) and total_pairs > cap
        if degraded:
            depth = max(k, cap // max(1, len(queries)))
            scored_lists = [sl[:depth] for sl in scored_lists]
        cascade_depth = self.cfg.rerank_cascade_depth or None
        with METRICS.timer("search.rerank"):
            window = self.reranker.rerank_window(
                queries, [[h.text for h in sl] for sl in scored_lists], k,
                cascade_depth=cascade_depth,
            )
        out_all = []
        for hits, scored, (ce_scores, order) in zip(hydrated, scored_lists, window):
            out = []
            for s, idx in zip(ce_scores.tolist(), order.tolist()):
                h = scored[idx]
                h.extras["dense_score"] = h.score
                h.score = float(s)
                if degraded:
                    h.extras["rerank_degraded"] = True
                if cascade_depth and len(scored) > max(k, cascade_depth):
                    # stage-1 pruning ran for this query
                    h.extras["rerank_cascade"] = cascade_depth
                out.append(h)
            # text-less candidates cannot be cross-encoded: they follow
            # the reranked set in dense order
            for h in hits:
                if len(out) >= k:
                    break
                if not h.text:
                    out.append(h)
            out_all.append(out)
        return out_all

    def _hybrid_merge(self, queries, dvals, drows, k, categories, alpha):
        """Union of the fetched dense candidates and the BM25 candidates,
        each min-max normalized per query, combined as
        alpha·dense + (1-alpha)·bm25; (scores [Q,k], rows [Q,k]) with
        (-inf, -1) in unfilled slots. BM25 fetches as many candidates as
        the dense scan did, for the whole window in one native call; with
        categories, BM25 candidates outside them are dropped."""
        c = dvals.shape[1]
        out_scores = np.full((len(queries), k), -np.inf, np.float32)
        out_rows = np.full((len(queries), k), -1, np.int64)
        cat_bits = (
            self.index.category_mask(categories)
            if categories is not None and self.index.row_masks is not None
            else None
        )

        def norm(v):
            if len(v) == 0:
                return v
            lo, hi = float(np.min(v)), float(np.max(v))
            if hi > lo:
                return (v - lo) / (hi - lo)
            # all-equal scores: all-zero means "no signal" (e.g. a
            # fully-OOV BM25 query) — give it no weight, not full
            return np.zeros_like(v) if hi == 0.0 else np.ones_like(v)

        with METRICS.timer("search.bm25"):
            bm25_window = self.bm25.topk_batch(queries, c)

        for qi in range(len(queries)):
            bvals, brows = bm25_window[qi]
            # padded and masked-out slots are -inf: dropped before the
            # min-max normalization (an -inf minimum makes every score NaN)
            dmask = (drows[qi] >= 0) & np.isfinite(dvals[qi])
            dv, dr = dvals[qi][dmask], drows[qi][dmask].astype(np.int64)
            if cat_bits is not None:
                bkeep = (self.index.row_masks[brows] & cat_bits) != 0
                bvals, brows = bvals[bkeep], brows[bkeep]
            nd_, nb_ = norm(dv), norm(bvals)
            uniq, inv = np.unique(
                np.concatenate([dr, brows.astype(np.int64)]), return_inverse=True
            )
            dacc = np.zeros(len(uniq), np.float32)
            bacc = np.zeros(len(uniq), np.float32)
            dacc[inv[: len(dr)]] = nd_
            bacc[inv[len(dr):]] = nb_
            comb = alpha * dacc + (1.0 - alpha) * bacc
            kk = min(k, len(uniq))
            top = np.argpartition(-comb, kk - 1)[:kk] if kk else np.array([], np.int64)
            top = top[np.argsort(-comb[top], kind="stable")]
            out_scores[qi, :kk] = comb[top]
            out_rows[qi, :kk] = uniq[top]
        return out_scores, out_rows

    # -- hydration ----------------------------------------------------------

    _META_COLS = ("chunk_id", "paper_id", "category", "section", "page", "text")
    _EAGER_META_MAX_ROWS = 200_000

    def _use_lazy_hydration(self) -> bool:
        if self.corpus is None:
            return False
        if self.lazy_hydration is not None:
            return self.lazy_hydration
        n = getattr(self.corpus, "num_rows", None)
        return (
            getattr(self.corpus, "take_rows", None) is not None
            and n is not None
            and n > self._EAGER_META_MAX_ROWS
        )

    def warm_hydration(self) -> int:
        """Prewarm lazy hydration: load every corpus row group into the
        reader's bounded cache and build the index → corpus row map, so
        serving windows never pay cold Parquet reads. No-op (returns 0)
        in eager mode. Returns the cached group count."""
        if not self._use_lazy_hydration():
            return 0
        self._index_to_corpus_rows()
        warm = getattr(self.corpus, "warm_cache", None)
        return warm(list(self._META_COLS)) if warm is not None else 0

    def _index_to_corpus_rows(self):
        """Index row → corpus row map for lazy hydration. ``None`` means
        identity (index built over the whole corpus in row order);
        otherwise an int64 array (-1: not in the corpus) built by one
        streaming pass over the chunk_id column."""
        if self._row_map is None:
            if self.index.chunk_ids is None:
                self._row_map = "identity"
            else:
                want = {cid: i for i, cid in enumerate(self.index.chunk_ids)}
                arr = np.full(len(self.index.chunk_ids), -1, np.int64)
                crow = 0
                for batch in self.corpus.iter_batches(columns=["chunk_id"]):
                    for cid in batch.column("chunk_id").to_pylist():
                        j = want.get(cid)
                        if j is not None and arr[j] < 0:
                            arr[j] = crow
                        crow += 1
                self._row_map = arr
        return None if isinstance(self._row_map, str) else self._row_map

    def _hydrate_window(self, scores, rows, qn) -> list[list[SearchResult]]:
        """Hydrate a whole window. Empty slots and padding (-inf) are
        dropped. Lazy mode fetches all the window's rows in one
        ``take_rows`` call (only the row groups holding hits); eager mode
        reads the in-memory table."""
        if not self._use_lazy_hydration():
            with METRICS.timer("search.hydrate"):
                return [self._hydrate(scores[i], rows[i]) for i in range(qn)]
        rmap = self._index_to_corpus_rows()
        keep: list[list[tuple[int, float, int]]] = []  # (index_row, score, flat_pos|-1)
        flat_corpus_rows: list[int] = []
        for qi in range(qn):
            entries = []
            for s, r in zip(scores[qi].tolist(), rows[qi].tolist()):
                if r < 0 or not np.isfinite(s):
                    continue
                cr = int(r) if rmap is None else int(rmap[r])
                if cr >= 0:
                    entries.append((int(r), float(s), len(flat_corpus_rows)))
                    flat_corpus_rows.append(cr)
                else:  # chunk_id not in this corpus: keep score + id only
                    entries.append((int(r), float(s), -1))
            keep.append(entries)
        with METRICS.timer("search.hydrate"):
            tbl = self.corpus.take_rows(flat_corpus_rows, columns=list(self._META_COLS))
        cols = {name: tbl.column(name).to_pylist() for name in self._META_COLS}
        out_all = []
        for entries in keep:
            out = []
            for r, s, fp in entries:
                res = SearchResult(row=r, score=s)
                if self.index.chunk_ids is not None:
                    res.chunk_id = self.index.chunk_ids[r]
                if fp >= 0:
                    res.chunk_id = cols["chunk_id"][fp]
                    res.paper_id = cols["paper_id"][fp]
                    res.category = cols["category"][fp]
                    res.section = cols["section"][fp]
                    res.page = int(cols["page"][fp])
                    res.text = cols["text"][fp]
                out.append(res)
            out_all.append(out)
        return out_all

    def _load_meta(self):
        if self._meta_cache is None and self.corpus is not None:
            table = self.corpus.read_all(columns=list(self._META_COLS))
            self._meta_cache = {
                name: table.column(name).to_pylist() for name in table.schema.names
            }
            self._meta_by_id = {
                cid: i for i, cid in enumerate(self._meta_cache["chunk_id"])
            }
        return self._meta_cache

    def _hydrate(self, scores, rows) -> list[SearchResult]:
        meta = self._load_meta()
        out = []
        for s, r in zip(scores.tolist(), rows.tolist()):
            if r < 0 or not np.isfinite(s):
                continue
            res = SearchResult(row=int(r), score=float(s))
            if meta is not None:
                # the index may cover a filtered subset of the corpus:
                # index row -> chunk_id -> corpus row when ids exist
                cr = r
                if self.index.chunk_ids is not None:
                    res.chunk_id = self.index.chunk_ids[r]
                    cr = self._meta_by_id.get(res.chunk_id, -1)
                if 0 <= cr < len(meta["chunk_id"]):
                    res.chunk_id = meta["chunk_id"][cr]
                    res.paper_id = meta["paper_id"][cr]
                    res.category = meta["category"][cr]
                    res.section = meta["section"][cr]
                    res.page = int(meta["page"][cr])
                    res.text = meta["text"][cr]
            out.append(res)
        return out

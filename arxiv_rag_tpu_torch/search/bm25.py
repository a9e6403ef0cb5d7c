"""BM25 keyword index, the sparse half of hybrid retrieval: the port's
own copy of ``arxiv_rag_tpu/search/bm25.py``.

Okapi BM25 (k1=1.5, b=0.75) over a CSR-style inverted index in numpy
arrays: scoring a query touches only the posting lists of its terms.
Large corpora build through the C++ index build and whole serving windows
score in one call of the C++ scorer (``search/bm25_native.py``); the
disk format (npz) is the reference's, so either package loads the
other's file.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def bm25_tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


@dataclass
class _Postings:
    doc_ids: np.ndarray  # int32
    tfs: np.ndarray  # float32


class BM25Index:
    def __init__(self, k1: float = 1.5, b: float = 0.75) -> None:
        self.k1 = k1
        self.b = b
        self.vocab: dict[str, int] = {}
        self.postings: list[_Postings] = []
        self.doc_lens: np.ndarray | None = None
        self.avg_len: float = 0.0
        self.num_docs: int = 0
        # derived caches (built once, lazily): per-term idf, per-doc
        # length norm, and a scratch accumulator reused across queries,
        # so a query allocates no dense [num_docs] vector
        self._idf_arr: np.ndarray | None = None
        self._norm: np.ndarray | None = None
        self._scratch: np.ndarray | None = None
        # flat CSR retained by _from_csr (native build / load) or built
        # on demand — the native batch scorer consumes these directly
        self._flat: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
        # the shared scratch makes topk non-reentrant: the
        # serve path has a single completion thread, but guard anyway so
        # concurrent engine.search() callers can't cross-contaminate
        self._lock = threading.Lock()

    @classmethod
    def build(
        cls,
        texts: Sequence[str],
        k1: float = 1.5,
        b: float = 0.75,
        native: bool | None = None,
    ) -> "BM25Index":
        """Build the inverted index. ``native=None`` auto-routes: the C++
        index build (native/bm25.cpp) for large corpora — the pure-Python
        per-token dict loop is ~360M interpreter ops at the 2M-chunk
        target — with the Python loop as portable fallback.

        Known tokenizer divergence in the native path: code points whose
        ``str.lower()`` maps INTO ascii (e.g. U+0130, U+212A) are
        separators natively but yield letters in Python. Vanishingly
        rare in arXiv text; everything ASCII-representable is identical.
        """
        if native is None:
            native = len(texts) >= 10_000
        if native:
            from arxiv_rag_tpu_torch.search import bm25_native

            csr = bm25_native.build_postings(texts)
            if csr is not None:
                terms, flat_ids, flat_tfs, posting_offsets, doc_lens = csr
                return cls._from_csr(
                    terms, flat_ids, flat_tfs, posting_offsets, doc_lens, k1, b
                )
        idx = cls(k1, b)
        term_docs: dict[str, dict[int, int]] = {}
        doc_lens = np.zeros(len(texts), np.float32)
        for doc_id, text in enumerate(texts):
            toks = bm25_tokenize(text)
            doc_lens[doc_id] = len(toks)
            for t in toks:
                term_docs.setdefault(t, {})
                term_docs[t][doc_id] = term_docs[t].get(doc_id, 0) + 1
        idx.doc_lens = doc_lens
        idx.avg_len = float(doc_lens.mean()) if len(texts) else 0.0
        idx.num_docs = len(texts)
        for term in sorted(term_docs):
            docs = term_docs[term]
            idx.vocab[term] = len(idx.postings)
            ids = np.fromiter(docs.keys(), np.int32, len(docs))
            tfs = np.fromiter(docs.values(), np.float32, len(docs))
            order = np.argsort(ids)
            idx.postings.append(_Postings(ids[order], tfs[order]))
        return idx

    @classmethod
    def _from_csr(
        cls, terms, flat_ids, flat_tfs, posting_offsets, doc_lens,
        k1: float = 1.5, b: float = 0.75,
    ) -> "BM25Index":
        idx = cls(k1, b)
        idx.doc_lens = np.asarray(doc_lens, np.float32)
        idx.num_docs = len(idx.doc_lens)
        idx.avg_len = float(idx.doc_lens.mean()) if idx.num_docs else 0.0
        flat_ids = np.asarray(flat_ids, np.int32)
        flat_tfs = np.asarray(flat_tfs, np.float32)
        for i, term in enumerate(terms):
            idx.vocab[term] = i
            s, e = posting_offsets[i], posting_offsets[i + 1]
            idx.postings.append(_Postings(flat_ids[s:e], flat_tfs[s:e]))
        idx._flat = (flat_ids, flat_tfs,
                     np.asarray(posting_offsets, np.int64))
        return idx

    def _csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(flat_ids, flat_tfs, posting_offsets) — zero-copy when built
        natively/loaded, one concatenation for Python-built indexes."""
        if self._flat is None:
            flat_ids = (np.concatenate([p.doc_ids for p in self.postings])
                        if self.postings else np.zeros(0, np.int32))
            flat_tfs = (np.concatenate([p.tfs for p in self.postings])
                        if self.postings else np.zeros(0, np.float32))
            offsets = np.cumsum(
                [0] + [len(p.doc_ids) for p in self.postings]
            ).astype(np.int64)
            self._flat = (flat_ids, flat_tfs, offsets)
        return self._flat

    def _derived(self) -> None:
        if self._idf_arr is None:
            dfs = np.fromiter(
                (len(p.doc_ids) for p in self.postings), np.float32, len(self.postings)
            )
            self._idf_arr = np.log(
                (self.num_docs - dfs + 0.5) / (dfs + 0.5) + 1.0
            ).astype(np.float32)
            self._norm = (
                self.doc_lens / self.avg_len if self.avg_len else self.doc_lens
            ).astype(np.float32)
            self._scratch = np.zeros(self.num_docs, np.float32)

    def _accumulate(self, query: str, out: np.ndarray) -> list[np.ndarray]:
        """Add each query term's contribution into ``out``; returns the
        touched posting id arrays (duplicate query terms contribute
        twice, matching classic query-tf weighting)."""
        touched: list[np.ndarray] = []
        for term in bm25_tokenize(query):
            tid = self.vocab.get(term)
            if tid is None:
                continue
            p = self.postings[tid]
            tf = p.tfs
            denom = tf + self.k1 * (1.0 - self.b + self.b * self._norm[p.doc_ids])
            out[p.doc_ids] += self._idf_arr[tid] * tf * (self.k1 + 1.0) / denom
            touched.append(p.doc_ids)
        return touched

    def scores(self, query: str) -> np.ndarray:
        """Dense [num_docs] score vector (only matched docs nonzero)."""
        out = np.zeros(self.num_docs, np.float32)
        if self.num_docs == 0:
            return out
        self._derived()
        self._accumulate(query, out)
        return out

    def topk(self, query: str, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Top scoring docs. Returns at most k MATCHED docs (fewer when
        the query matches fewer — zero-score padding rows would only
        pollute hybrid unions). Scoring touches only the query terms'
        posting lists via a reused scratch accumulator, so at 2M docs a
        query pays no dense allocation and no full argpartition."""
        if self.num_docs == 0 or k <= 0:
            return np.zeros(0, np.float32), np.zeros(0, np.int64)
        with self._lock:
            self._derived()
            out = self._scratch
            touched = self._accumulate(query, out)
            if not touched:
                return np.zeros(0, np.float32), np.zeros(0, np.int64)
            cand = np.unique(np.concatenate(touched))
            svals = out[cand]
            kk = min(k, len(cand))
            sel = np.argpartition(-svals, kk - 1)[:kk]
            sel = sel[np.argsort(-svals[sel], kind="stable")]
            res = svals[sel].copy(), cand[sel].astype(np.int64)
            out[cand] = 0.0  # reset scratch for the next query
            return res

    def topk_batch(
        self, queries: Sequence[str], k: int
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Top-k per query for a whole serving window in ONE native call
        (native/bm25.cpp::arag_bm25_score_topk): a per-query Python
        loop bounds hybrid serving at Q=512 windows. Falls back to that
        loop (``topk`` per query) when the native scorer is unavailable."""
        if self.num_docs == 0 or k <= 0 or not queries:
            return [(np.zeros(0, np.float32), np.zeros(0, np.int64))
                    for _ in queries]
        from arxiv_rag_tpu_torch.search import bm25_native

        if not bm25_native.is_available():
            return [self.topk(q, k) for q in queries]
        with self._lock:
            self._derived()
            flat_ids, flat_tfs, offsets = self._csr()
            idf, norm = self._idf_arr, self._norm
        q_terms: list[int] = []
        q_offsets = [0]
        for q in queries:
            for t in bm25_tokenize(q):
                tid = self.vocab.get(t)
                if tid is not None:  # OOV terms score nothing anyway
                    q_terms.append(tid)
            q_offsets.append(len(q_terms))
        scores, ids, counts = bm25_native.score_topk(
            flat_ids, flat_tfs, offsets, idf, norm, self.num_docs,
            self.k1, self.b,
            np.asarray(q_terms, np.int32), np.asarray(q_offsets, np.int64),
            k,
        )
        return [(scores[i, : counts[i]], ids[i, : counts[i]])
                for i in range(len(queries))]

    # -- persistence (npz + vocab) ----------------------------------------

    def save(self, path: str | Path) -> None:
        # np.savez appends .npz when missing; normalize so save/load
        # accept the same path
        path = Path(path)
        if path.suffix != ".npz":
            path = path.with_suffix(path.suffix + ".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        flat_ids = np.concatenate([p.doc_ids for p in self.postings]) if self.postings else np.zeros(0, np.int32)
        flat_tfs = np.concatenate([p.tfs for p in self.postings]) if self.postings else np.zeros(0, np.float32)
        offsets = np.cumsum([0] + [len(p.doc_ids) for p in self.postings]).astype(np.int64)
        np.savez_compressed(
            path,
            terms=np.array(list(self.vocab.keys())),
            flat_ids=flat_ids,
            flat_tfs=flat_tfs,
            offsets=offsets,
            doc_lens=self.doc_lens,
            meta=np.array([self.k1, self.b, self.avg_len, self.num_docs], np.float64),
        )

    @classmethod
    def load(cls, path: str | Path) -> "BM25Index":
        path = Path(path)
        if path.suffix != ".npz" and not path.exists():
            path = path.with_suffix(path.suffix + ".npz")
        z = np.load(path, allow_pickle=False)
        k1, b, avg_len, num_docs = z["meta"]
        idx = cls._from_csr(
            [str(t) for t in z["terms"]],
            z["flat_ids"], z["flat_tfs"], z["offsets"], z["doc_lens"],
            float(k1), float(b),
        )
        # trust the saved stats (float64) over the recomputed ones
        idx.avg_len = float(avg_len)
        idx.num_docs = int(num_docs)
        return idx

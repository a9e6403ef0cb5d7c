"""Retrieval-quality evaluation: the port's own copy of
``arxiv_rag_tpu/evaluate.py`` (:27-101). Paper titles come from
``pipeline.repair.load_paper_titles``, as in the reference.

Self-supervised protocol over any built corpus: each paper's title
becomes a query and the paper's own chunks are the relevant set.
Reports recall@k, MRR@k and hit@1 of the end-to-end engine (dense,
hybrid or reranked), so a retrieval change is measured on any corpus
without labelled data.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


@dataclass
class EvalResult:
    queries: int
    k: int
    recall_at_k: float
    mrr_at_k: float
    hit_at_1: float
    by_variant: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "queries": self.queries,
            "k": self.k,
            "recall_at_k": round(self.recall_at_k, 4),
            "mrr_at_k": round(self.mrr_at_k, 4),
            "hit_at_1": round(self.hit_at_1, 4),
            **({"by_variant": self.by_variant} if self.by_variant else {}),
        }


def title_queries(
    corpus_reader, titles: dict[str, str], max_queries: int = 256
) -> tuple[list[str], list[set[str]]]:
    """(queries, relevant chunk_id sets) from paper titles longer than 10
    characters, papers in id order."""
    chunks_of: dict[str, set[str]] = {}
    for batch in corpus_reader.iter_batches(columns=["paper_id", "chunk_id"]):
        for row in batch.to_pylist():
            chunks_of.setdefault(row["paper_id"], set()).add(row["chunk_id"])
    queries: list[str] = []
    relevant: list[set[str]] = []
    for pid, chunk_ids in sorted(chunks_of.items()):
        title = titles.get(pid, "")
        if len(title) > 10 and chunk_ids:
            queries.append(title)
            relevant.append(chunk_ids)
        if len(queries) >= max_queries:
            break
    return queries, relevant


def evaluate_engine(
    engine,
    queries: Sequence[str],
    relevant: Sequence[set[str]],
    k: int = 10,
    batch: int = 32,
    **search_kw,
) -> EvalResult:
    """recall@k / MRR@k / hit@1 of ``engine.search`` over the query set,
    ``batch`` queries a call."""
    hits_at_1 = 0
    recalls: list[float] = []
    rrs: list[float] = []
    for start in range(0, len(queries), batch):
        qs = list(queries[start : start + batch])
        rels = relevant[start : start + batch]
        results = engine.search(qs, k=k, **search_kw)
        for hits, rel in zip(results, rels):
            got = [h.chunk_id for h in hits if h.chunk_id]
            found = sum(1 for cid in got if cid in rel)
            recalls.append(found / min(len(rel), k) if rel else 0.0)
            rr = 0.0
            for rank, cid in enumerate(got, start=1):
                if cid in rel:
                    rr = 1.0 / rank
                    break
            rrs.append(rr)
            if got and got[0] in rel:
                hits_at_1 += 1
    n = len(recalls)
    return EvalResult(
        queries=n,
        k=k,
        recall_at_k=float(np.mean(recalls)) if n else 0.0,
        mrr_at_k=float(np.mean(rrs)) if n else 0.0,
        hit_at_1=hits_at_1 / n if n else 0.0,
    )

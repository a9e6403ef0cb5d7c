"""Corpus audit: census, quality, duplicates, token stats, readiness.

The port's own copy of ``arxiv_rag_tpu/audit.py``.

One subsystem replacing the reference's five analyzer CLIs
(``analyze_all_chunks.py``, ``analyze_json_quality.py``,
``analyze_for_embeddings.py``, ``final_embedding_analysis.py``,
``analyze_extraction_results.py``) — the same signal families computed
in one streaming pass over the columnar corpus store:

- chunk census: counts, char/token distributions, per-category and
  per-section splits (``analyze_all_chunks.py:49-…``);
- quality distribution and gate counts (keep ≥0.7 / embed ≥0.9,
  ``fix_chunk_issues.py:311``, ``generate_embeddings_parallel.py:476``);
- model-limit checks: chunks above the encoder token budget, below the
  50-token floor, inside the 50–512 optimal band
  (``analyze_for_embeddings.py:91-96,140-154``);
- duplicate-text detection by content hash
  (``final_embedding_analysis.py:229-234``);
- content-type flags: url-only / citation-heavy / table-ish / equation-
  heavy (``final_embedding_analysis.py:209-222``);
- per-paper RAG-readiness score 0–10 with deductions
  (``analyze_json_quality.py:39-225``);
- verdict tiers + recommendations (``final_embedding_analysis.py:430-450``).
"""

from __future__ import annotations

import hashlib
import json
import re
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from pathlib import Path

from arxiv_rag_tpu_torch.pipeline.extract.quality import EXPECTED_CHARS_PER_PAGE
from arxiv_rag_tpu_torch.store.corpus import CorpusReader

# Per-embedding-model optimal token bands (reference
# ``analyze_for_embeddings.py:91-96``): (floor, optimal_ceiling, hard_limit).
# The hard limit is the model's real context window; chunks between the
# optimal ceiling and the hard limit embed but truncate semantic tails.
MODEL_BANDS: dict[str, tuple[int, int, int]] = {
    "mpnet": (50, 384, 512),  # all-mpnet-base-v2: 384 recommended, 512 max
    "sentence_transformers": (50, 512, 512),
    "minilm": (50, 256, 512),
    "openai": (50, 8192, 8192),
    "cohere": (50, 2048, 2048),
}
DEFAULT_MODEL = "mpnet"

_URL_ONLY = re.compile(r"^\s*(https?://\S+\s*)+$")
_EQUATION = re.compile(r"[=∑∫√±≤≥≈]|\\[a-z]+")
_CITATION = re.compile(r"\[\d+(?:[,\-–]\s*\d+)*\]")
_TABLE_ROW = re.compile(r"(\S+\s{2,}){3,}\S+")


@dataclass
class AuditReport:
    num_chunks: int = 0
    num_papers: int = 0
    chars: dict = field(default_factory=dict)
    tokens: dict = field(default_factory=dict)
    quality: dict = field(default_factory=dict)
    categories: dict = field(default_factory=dict)
    sections: dict = field(default_factory=dict)
    duplicates: int = 0
    duplicate_groups: int = 0
    content_flags: dict = field(default_factory=dict)
    token_bands: dict = field(default_factory=dict)
    token_bands_by_model: dict = field(default_factory=dict)
    gates: dict = field(default_factory=dict)
    paper_scores: dict = field(default_factory=dict)  # tier -> count
    recommendations: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


def _dist(values: list[float]) -> dict:
    if not values:
        return {"count": 0}
    vs = sorted(values)
    n = len(vs)
    return {
        "count": n,
        "min": vs[0],
        "p25": vs[n // 4],
        "median": vs[n // 2],
        "p75": vs[3 * n // 4],
        "max": vs[-1],
        "mean": round(sum(vs) / n, 2),
    }


def _token_estimate(text: str) -> int:
    return max(1, len(text) // 4)


def audit_corpus(
    corpus_dir: str | Path,
    max_tokens: int | None = None,
    optimal_band: tuple[int, int] | None = None,
    keep_quality: float = 0.7,
    embed_quality: float = 0.9,
    model: str = DEFAULT_MODEL,
) -> AuditReport:
    """Audit a chunk corpus for embedding readiness.

    ``model`` selects the token-band profile from :data:`MODEL_BANDS`
    (reference ``analyze_for_embeddings.py:91-96`` kept one table for
    several embedding providers); explicit ``max_tokens`` /
    ``optimal_band`` override the profile.
    """
    if model not in MODEL_BANDS:
        raise ValueError(f"unknown embed model {model!r}; known: {sorted(MODEL_BANDS)}")
    floor, ceil, hard = MODEL_BANDS[model]
    if optimal_band is None:
        optimal_band = (floor, ceil)
    if max_tokens is None:
        max_tokens = hard
    reader = CorpusReader(corpus_dir)
    rep = AuditReport()

    char_counts: list[float] = []
    token_counts: list[float] = []
    qualities: list[float] = []
    papers: set[str] = set()
    hashes: Counter[str] = Counter()
    flags = Counter()
    bands = Counter()
    per_paper_chunks: Counter[str] = Counter()
    per_paper_quality: dict[str, list[float]] = defaultdict(list)

    for batch in reader.iter_batches(
        columns=["paper_id", "text", "quality", "category", "section", "token_count"]
    ):
        texts = batch.column("text").to_pylist()
        pids = batch.column("paper_id").to_pylist()
        quals = batch.column("quality").to_pylist()
        cats = batch.column("category").to_pylist()
        secs = batch.column("section").to_pylist()
        toks = batch.column("token_count").to_pylist()
        for pid, text, qual, cat, sec, tok in zip(pids, texts, quals, cats, secs, toks):
            rep.num_chunks += 1
            papers.add(pid)
            per_paper_chunks[pid] += 1
            per_paper_quality[pid].append(qual)
            n_tok = tok or _token_estimate(text)
            char_counts.append(len(text))
            token_counts.append(n_tok)
            qualities.append(qual)
            rep.categories[cat] = rep.categories.get(cat, 0) + 1
            if sec:
                rep.sections[sec] = rep.sections.get(sec, 0) + 1
            hashes[hashlib.sha1(text.strip().lower().encode()).hexdigest()[:16]] += 1
            # content-type flags
            if _URL_ONLY.match(text):
                flags["url_only"] += 1
            if len(_CITATION.findall(text)) >= 5:
                flags["citation_heavy"] += 1
            if len(_EQUATION.findall(text)) > len(text) / 40:
                flags["equation_heavy"] += 1
            if sum(bool(_TABLE_ROW.search(l)) for l in text.splitlines()) >= 3:
                flags["table_like"] += 1
            # token bands
            if n_tok > max_tokens:
                bands["over_limit"] += 1
            elif n_tok < optimal_band[0]:
                bands["under_optimal"] += 1
            elif n_tok <= optimal_band[1]:
                bands["optimal"] += 1
            else:
                bands["above_optimal"] += 1

    rep.num_papers = len(papers)
    rep.chars = _dist(char_counts)
    rep.tokens = _dist(token_counts)
    rep.quality = _dist(qualities)
    rep.content_flags = dict(flags)
    rep.token_bands = dict(bands)
    # cross-model readiness: same counts under every known profile
    for name, (m_floor, m_ceil, m_hard) in MODEL_BANDS.items():
        mb = Counter()
        for t in token_counts:
            if t > m_hard:
                mb["over_limit"] += 1
            elif t < m_floor:
                mb["under_optimal"] += 1
            elif t <= m_ceil:
                mb["optimal"] += 1
            else:
                mb["above_optimal"] += 1
        rep.token_bands_by_model[name] = dict(mb)
    dup_groups = {h: c for h, c in hashes.items() if c > 1}
    rep.duplicate_groups = len(dup_groups)
    rep.duplicates = sum(c - 1 for c in dup_groups.values())
    rep.gates = {
        "below_keep_quality": sum(1 for q in qualities if q < keep_quality),
        "below_embed_quality": sum(1 for q in qualities if q < embed_quality),
        "embeddable": sum(1 for q in qualities if q >= embed_quality),
    }

    # per-paper readiness (0-10): deductions mirror analyze_json_quality.py:39-225
    tiers = Counter()
    for pid in papers:
        score = 10.0
        n = per_paper_chunks[pid]
        avg_q = sum(per_paper_quality[pid]) / n
        if n == 0:
            score -= 5
        elif n < 3:
            score -= 2
        if avg_q < keep_quality:
            score -= 3
        elif avg_q < embed_quality:
            score -= 1
        tier = "excellent" if score >= 9 else "good" if score >= 7 else "fair" if score >= 5 else "poor"
        tiers[tier] += 1
    rep.paper_scores = dict(tiers)

    # recommendations
    if rep.duplicates > rep.num_chunks * 0.02:
        rep.recommendations.append(
            f"{rep.duplicates} duplicate chunks (>2%): run `arag repair` (drops exact duplicates)"
        )
    if bands.get("over_limit", 0):
        rep.recommendations.append(
            f"{bands['over_limit']} chunks exceed {max_tokens} tokens: run `arag repair` (splits at --max-chars)"
        )
    if rep.gates["below_keep_quality"] > rep.num_chunks * 0.1:
        rep.recommendations.append(
            f"{rep.gates['below_keep_quality']} chunks below keep-quality {keep_quality}: "
            "re-extract or run `arag repair --min-quality 0.7`"
        )
    if bands.get("under_optimal", 0) > rep.num_chunks * 0.2:
        rep.recommendations.append(
            f"{bands['under_optimal']} chunks under {optimal_band[0]} tokens: consider merging"
        )
    if not rep.recommendations:
        rep.recommendations.append("corpus is embedding-ready")
    return rep


def audit_extractions(extracted_dir: str | Path) -> dict:
    """Report over `arag extract` output JSONs (reference:
    ``analyze_extraction_results.py`` — quality-score distribution,
    per-method effectiveness, chars/page stats, recommendations)."""
    root = Path(extracted_dir)
    per_method: dict[str, list[float]] = defaultdict(list)
    scores: list[float] = []
    chars_per_page: list[float] = []
    failed = 0
    errors_file = root / "_extraction_errors.jsonl"
    if errors_file.exists():
        failed = sum(1 for _ in errors_file.open())
    for path in root.rglob("*.json"):
        if path.name.startswith("_"):
            continue
        try:
            rec = json.loads(path.read_text())
        except json.JSONDecodeError:
            continue
        if "quality_score" not in rec:
            continue
        q = float(rec["quality_score"])
        scores.append(q)
        per_method[rec.get("method_used", "?")].append(q)
        pages = rec.get("pages") or []
        if pages:
            chars_per_page.append(len(rec.get("text", "")) / len(pages))
    out = {
        "documents": len(scores),
        "failed": failed,
        "quality": _dist(scores),
        "chars_per_page": _dist(chars_per_page),
        "by_method": {
            m: {"count": len(v), "mean_quality": round(sum(v) / len(v), 4)}
            for m, v in sorted(per_method.items())
        },
        "recommendations": [],
    }
    low = sum(1 for s in scores if s < 0.5)
    if scores and low > 0.1 * len(scores):
        out["recommendations"].append(
            f"{low}/{len(scores)} documents under quality 0.5: inspect the "
            "error ledger and consider OCR for scanned sources"
        )
    if chars_per_page and _dist(chars_per_page)["median"] < EXPECTED_CHARS_PER_PAGE * 0.4:
        out["recommendations"].append(
            "median chars/page well below the ~2500 expectation: extraction "
            "may be dropping content"
        )
    if not out["recommendations"]:
        out["recommendations"].append("extraction quality looks healthy")
    return out


def format_report(rep: AuditReport) -> str:
    lines = [
        "=== corpus audit ===",
        f"papers: {rep.num_papers}   chunks: {rep.num_chunks}",
        f"chars:  {rep.chars}",
        f"tokens: {rep.tokens}",
        f"quality:{rep.quality}",
        f"token bands: {rep.token_bands}",
        f"token bands by model: {rep.token_bands_by_model}",
        f"quality gates: {rep.gates}",
        f"duplicates: {rep.duplicates} in {rep.duplicate_groups} groups",
        f"content flags: {rep.content_flags}",
        f"categories: {dict(sorted(rep.categories.items(), key=lambda kv: -kv[1]))}",
        f"paper readiness: {rep.paper_scores}",
        "recommendations:",
        *[f"  - {r}" for r in rep.recommendations],
    ]
    return "\n".join(lines)


def save_report(rep: AuditReport, path: str | Path) -> None:
    Path(path).write_text(json.dumps(rep.to_dict(), indent=1))

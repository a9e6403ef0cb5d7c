"""Paper augmentation: light payloads for retrieval-time display.

The port's own copy of ``arxiv_rag_tpu/pipeline/augment.py``.

Parity with ``3-chunks/improvement/improve_chunks.py``: keyword
extraction with abstract-first TF fallback (:38-45,209-214), Flesch
reading-ease (:15-27), token estimate + 8000-token budget truncation
(:10-12,200-207), section index (:47-58), citation map with spans
(:60-121), figure placeholders (:123-135), author emails (:137-143),
2-sentence summary (:145-147), domain tags (:149-157), and the
``--min-readability`` / ``--min-citations`` quality filters (:229-231).
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass, field

from arxiv_rag_tpu_torch.pipeline.chunk import split_sentences
from arxiv_rag_tpu_torch.pipeline.citations import extract_citations
from arxiv_rag_tpu_torch.pipeline.sections import extract_sections

_WORD = re.compile(r"[A-Za-z][A-Za-z\-]{2,}")
_VOWELS = re.compile(r"[aeiouy]+")
_FIGURE = re.compile(r"\b(Figure|Fig\.?|Table)\s+(\d+[a-z]?)", re.IGNORECASE)
_EMAIL = re.compile(r"[\w.+-]+@[\w-]+\.[\w.]+")
_STOP = frozenset(
    "the a an of and or to in for with on by is are was were be been this that "
    "these those we our it its as at from which can may such not have has had "
    "using used use show shown result results method methods model models "
    "paper approach section figure table".split()
)

DOMAIN_KEYWORDS = {
    "machine-learning": {"learning", "training", "neural", "gradient", "optimization", "model"},
    "computer-vision": {"image", "visual", "pixel", "segmentation", "detection", "video"},
    "nlp": {"language", "text", "token", "word", "sentence", "translation", "linguistic"},
    "security": {"attack", "adversarial", "security", "privacy", "encryption", "vulnerability"},
    "systems": {"distributed", "latency", "throughput", "scheduling", "memory", "hardware"},
    "theory": {"theorem", "proof", "bound", "complexity", "convergence", "lemma"},
    "retrieval": {"retrieval", "search", "ranking", "query", "index", "relevance"},
}


def estimate_tokens(text: str) -> int:
    return max(1, len(text) // 4)


def flesch_reading_ease(text: str) -> float:
    """Flesch score via a cheap syllable proxy (vowel groups)."""
    sents = split_sentences(text) or [(0, len(text))]
    words = _WORD.findall(text)
    if not words:
        return 0.0
    syllables = sum(max(1, len(_VOWELS.findall(w.lower()))) for w in words)
    n_words, n_sents = len(words), max(1, len(sents))
    score = 206.835 - 1.015 * (n_words / n_sents) - 84.6 * (syllables / n_words)
    return round(max(-100.0, min(121.0, score)), 2)


def extract_keywords(text: str, abstract: str = "", n: int = 10) -> list[str]:
    """Abstract-first keyword pull; TF fallback over the body."""
    source = abstract if len(abstract) > 100 else text[:5000]
    counts = Counter(
        w.lower() for w in _WORD.findall(source) if w.lower() not in _STOP and len(w) > 3
    )
    return [w for w, _ in counts.most_common(n)]


def summarize(abstract: str, text: str, n_sentences: int = 2) -> str:
    src = abstract if len(abstract) > 50 else text
    spans = split_sentences(src)[:n_sentences]
    return " ".join(src[a:b].strip() for a, b in spans)


def domain_tags(keywords: list[str], text: str) -> list[str]:
    lowered = set(keywords) | {w.lower() for w in _WORD.findall(text[:3000])}
    return sorted(tag for tag, vocab in DOMAIN_KEYWORDS.items() if len(vocab & lowered) >= 2)


def figure_placeholders(text: str) -> list[dict]:
    out = []
    seen = set()
    for m in _FIGURE.finditer(text):
        key = (m.group(1).lower().rstrip("."), m.group(2))
        if key in seen:
            continue
        seen.add(key)
        kind = "figure" if key[0].startswith("fig") else key[0]
        out.append({"kind": kind, "label": m.group(2), "offset": m.start()})
    return out


@dataclass
class LightPayload:
    paper_id: str
    title: str = ""
    summary: str = ""
    keywords: list[str] = field(default_factory=list)
    domains: list[str] = field(default_factory=list)
    readability: float = 0.0
    token_estimate: int = 0
    truncated: bool = False
    section_index: list[dict] = field(default_factory=list)
    citation_map: list[dict] = field(default_factory=list)
    figures: list[dict] = field(default_factory=list)
    emails: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


def build_light_payload(
    paper_id: str,
    text: str,
    title: str = "",
    abstract: str = "",
    token_budget: int = 8000,
) -> LightPayload:
    """Assemble the per-paper payload (``improve_chunks.py:168-249``)."""
    truncated = False
    if estimate_tokens(text) > token_budget:
        text = text[: token_budget * 4]
        truncated = True
    smap = extract_sections(text)
    cits = extract_citations(text, smap)
    kw = extract_keywords(text, abstract)
    return LightPayload(
        paper_id=paper_id,
        title=title,
        summary=summarize(abstract, text),
        keywords=kw,
        domains=domain_tags(kw, text),
        readability=flesch_reading_ease(text[:10000]),
        token_estimate=estimate_tokens(text),
        truncated=truncated,
        section_index=[
            {"name": s.name, "start": s.start_char, "end": s.end_char, "page": s.page}
            for s in smap.sections
        ],
        citation_map=[
            {"raw": c.raw, "keys": c.keys, "start": c.start, "end": c.end, "section": c.section}
            for c in cits[:200]
        ],
        figures=figure_placeholders(text),
        emails=sorted(set(_EMAIL.findall(text[:5000]))),
    )


def passes_filters(
    payload: LightPayload,
    min_readability: float | None = None,
    min_citations: int | None = None,
) -> bool:
    if min_readability is not None and payload.readability < min_readability:
        return False
    if min_citations is not None and len(payload.citation_map) < min_citations:
        return False
    return True

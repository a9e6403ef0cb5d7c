"""Extraction quality scoring + validation.

The port's own copy of ``arxiv_rag_tpu/pipeline/extract/quality.py``.

Keeps the reference's *objective* — a 0..1 score used to pick the best
extraction strategy and to gate downstream stages — with the same
signal families as ``pdf_extractor.py:7595-7770`` (chars/page density
vs the ~2,500 expectation at :7618, word-ratio, garbage-character rate,
structure hints) and the validator severity model of
``pdf_extractor.py:7397-7455`` / ``extraction_improver.py:332-420``.
The implementation is fresh and much smaller: one pass of counters over
the text, no regex army.

Signals adopted from the reference's *enhanced* scorer
(``pdf_extractor.py:7776-8330``) after a signal-by-signal audit
(dispositions in ``PARITY.md``): broken-word ratio (coherence :7966),
whitespace-run rate (accuracy :8103), and section/numbered-heading
structure hints (structure :8023-8060). Metadata completeness,
page-consistency CV, recommendations and confidence are deliberately
out of scope here — see PARITY.md for where each lives instead.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

EXPECTED_CHARS_PER_PAGE = 2500.0  # reference: pdf_extractor.py:7618

_WORD_RE = re.compile(r"[A-Za-z]{2,}")
# Broken-word signal (reference coherence dimension, pdf_extractor.py:7966):
# the reference greps r"\b[a-z]\s+[A-Z][a-z]", which false-positives on
# ordinary prose ("a World"). Fresh design: kern-gap word breaks shed
# 1-2 letter lowercase orphans ("t he", "ex ample"); genuine 1-2 letter
# English words are a closed class, so count the out-of-class ones.
# 3-letter content words (fox, map, gpu) are common — length stops at 2.
_SHORT_OK = frozenset(
    "a i an as at be by do he if in is it me my no of on or so to up us we"
    " eg ie et al eq vs st nd rd th".split()
)
_WS_RUN_RE = re.compile(r" {3,}|\n{4,}")  # reference accuracy dim :8103
_NUMBERED_HEADING_RE = re.compile(r"\n\s*\d{1,2}\.?\s+[A-Z][a-z]")  # :8046
_SECTION_MARKERS = (
    "abstract",
    "introduction",
    "method",
    "result",
    "experiment",
    "conclusion",
    "reference",
    "discussion",
)
_COMMON_WORDS = frozenset(
    "the of and to in a is that for we with as on this by are be it from"
    " an our which can at or has not have model all results using data"
    " method section figure table between where these both than each".split()
)


@dataclass
class QualityReport:
    score: float
    chars_per_page: float
    word_ratio: float
    garbage_ratio: float
    ascii_ratio: float
    common_word_hits: int
    broken_ratio: float = 0.0
    ws_run_rate: float = 0.0
    structure_hits: int = 0
    issues: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.score >= 0.5 and not any(i.startswith("critical:") for i in self.issues)


def score_text(text: str, num_pages: int = 1) -> QualityReport:
    """0..1 quality score for an extraction candidate."""
    n = len(text)
    num_pages = max(1, num_pages)
    if n == 0:
        return QualityReport(0.0, 0.0, 0.0, 1.0, 0.0, 0, ["critical:empty"])

    # single pass counters
    letters = digits = spaces = garbage = ascii_printable = 0
    replacement = 0
    for ch in text:
        o = ord(ch)
        if ch.isalpha():
            letters += 1
        elif ch.isdigit():
            digits += 1
        elif ch.isspace():
            spaces += 1
        if 0x20 <= o < 0x7F:
            ascii_printable += 1
        if o == 0xFFFD:
            replacement += 1
            garbage += 1
        elif o < 0x20 and ch not in "\n\t\r":
            garbage += 1
        elif 0xE000 <= o <= 0xF8FF:  # private use area = failed glyph map
            garbage += 1

    sample = text[:20000]
    words = _WORD_RE.findall(sample)
    lowered = [w.lower() for w in words[:4000]]
    common_hits = sum(1 for w in lowered if w in _COMMON_WORDS)

    # broken-word fragments (enhanced-scorer coherence, see header)
    alpha_tokens = [t for t in sample.split() if t.isalpha()]
    short_frag = sum(
        1 for t in alpha_tokens if len(t) <= 2 and t.islower() and t not in _SHORT_OK
    )
    broken_ratio = short_frag / max(1, len(alpha_tokens))

    # whitespace runs per 1k chars (enhanced-scorer accuracy dim :8103)
    ws_run_rate = len(_WS_RUN_RE.findall(sample)) / max(1.0, len(sample) / 1000.0)

    # structure hints: section markers + numbered headings (:8023-8060)
    sample_lower = sample.lower()
    structure_hits = sum(1 for m in _SECTION_MARKERS if m in sample_lower)
    structure_hits += min(4, len(_NUMBERED_HEADING_RE.findall(sample)))

    chars_per_page = n / num_pages
    word_chars = sum(len(w) for w in words)
    sample_len = min(n, 20000)
    word_ratio = word_chars / max(1, sample_len)
    garbage_ratio = garbage / n
    ascii_ratio = ascii_printable / n

    # component scores
    density = min(1.0, chars_per_page / EXPECTED_CHARS_PER_PAGE)
    # below ~200 chars/page is almost certainly a failed extraction
    if chars_per_page < 200:
        density *= 0.3
    wordiness = min(1.0, word_ratio / 0.6)
    cleanliness = max(0.0, 1.0 - garbage_ratio * 20.0)
    # real English text has common words; formula-only garbage doesn't
    commonness = min(1.0, common_hits / max(8.0, len(lowered) * 0.08)) if lowered else 0.0

    structure = min(1.0, structure_hits / 6.0)

    score = (
        0.33 * density
        + 0.24 * wordiness
        + 0.24 * cleanliness
        + 0.13 * commonness
        + 0.06 * structure
    )
    # heavy garbage gates the whole score, not just its component
    if garbage_ratio > 0.02:
        score *= max(0.0, 1.0 - garbage_ratio * 4.0)
    # broken-word fragments gate too: clean prose sits well under ~4%
    # short out-of-class fragments; mid-word breaks push far above
    if broken_ratio > 0.04:
        score *= max(0.2, 1.0 - (broken_ratio - 0.04) * 5.0)
    # excessive whitespace runs (reference accuracy dim): mild multiplier
    if ws_run_rate > 5.0:
        score *= 0.9

    issues: list[str] = []
    if chars_per_page < 100:
        issues.append("critical:too_little_text")
    if garbage_ratio > 0.10:
        issues.append("critical:garbage_text")
    elif garbage_ratio > 0.02:
        issues.append("warning:some_garbage")
    if word_ratio < 0.2:
        issues.append("warning:low_word_ratio")
    if replacement > n * 0.01:
        issues.append("warning:replacement_chars")
    if broken_ratio > 0.08:
        issues.append("warning:broken_words")
    return QualityReport(
        score=max(0.0, min(1.0, score)),
        chars_per_page=chars_per_page,
        word_ratio=word_ratio,
        garbage_ratio=garbage_ratio,
        ascii_ratio=ascii_ratio,
        common_word_hits=common_hits,
        broken_ratio=broken_ratio,
        ws_run_rate=ws_run_rate,
        structure_hits=structure_hits,
        issues=issues,
    )


@dataclass
class ValidationResult:
    valid: bool
    severity: str  # ok | warning | error
    issues: list[str]


def validate_extraction(
    pages: list[str],
    min_quality: float = 0.5,
    min_chars_per_page: float = 200.0,
    max_empty_page_frac: float = 0.3,
) -> ValidationResult:
    """Document-level validation (reference: QualityValidator,
    ``extraction_improver.py:546-665`` — thresholds relaxed to realistic
    levels; the reference's 0.95 gate rejected most real papers)."""
    issues: list[str] = []
    if not pages:
        return ValidationResult(False, "error", ["no pages extracted"])
    text = "\n".join(pages)
    rep = score_text(text, num_pages=len(pages))
    empty = sum(1 for p in pages if len(p.strip()) < 20)
    if rep.score < min_quality:
        issues.append(f"quality {rep.score:.2f} < {min_quality}")
    if rep.chars_per_page < min_chars_per_page:
        issues.append(f"chars/page {rep.chars_per_page:.0f} < {min_chars_per_page:.0f}")
    if empty / len(pages) > max_empty_page_frac:
        issues.append(f"{empty}/{len(pages)} pages empty")
    severity = "ok" if not issues else ("warning" if rep.score >= 0.35 else "error")
    return ValidationResult(not issues, severity, issues)

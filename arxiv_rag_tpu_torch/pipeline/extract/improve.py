"""Post-extraction improvement pass.

The port's own copy of ``arxiv_rag_tpu/pipeline/extract/improve.py``.

Parity with ``extraction_improver.py``: watermark-line removal
(:27-40,157-213), footer/boilerplate removal (:43-52,215-281),
repeated-content collapse (:422-483), and re-scoring (:485-538) —
implemented as one line-oriented pass with page-frequency statistics
instead of twelve independent regex sweeps.
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass

from .quality import score_text

_WATERMARK_PATTERNS = [
    re.compile(r"^\s*arXiv:\s*\d{4}\.\d{4,5}(v\d+)?\s*(\[[\w.\-]+\])?\s*\d{1,2}\s+\w{3}\s+\d{4}\s*$", re.I),
    re.compile(r"^\s*preprint\.?\s*(under review\.?)?\s*$", re.I),
    re.compile(r"^\s*under review as a conference paper.*$", re.I),
    re.compile(r"^\s*accepted (at|to|for) .{0,60}$", re.I),
    re.compile(r"^\s*to appear in .{0,60}$", re.I),
    re.compile(r"^\s*©?\s*\d{4}\s+(IEEE|ACM|Springer|Elsevier).*$", re.I),
    re.compile(r"^\s*this work is licensed under.*$", re.I),
    re.compile(r"^\s*proceedings of the .{0,80}$", re.I),
    re.compile(r"^\s*draft($| version.*$)", re.I),
    re.compile(r"^\s*confidential.*$", re.I),
]
_PAGE_NUMBER = re.compile(r"^\s*(page\s+)?\d{1,4}(\s+of\s+\d{1,4})?\s*$", re.I)


@dataclass
class ImproveResult:
    pages: list[str]
    removed_lines: int
    quality_score: float


def _line_fingerprint(line: str) -> str:
    """Normalize a line for repeated-header/footer detection: digits
    collapse so 'Page 3' and 'Page 17' match."""
    return re.sub(r"\d+", "#", line.strip().lower())[:80]


def improve_pages(pages: list[str], repeat_frac: float = 0.5) -> ImproveResult:
    """Remove watermarks, page numbers, and lines repeating on ≥
    ``repeat_frac`` of pages (running headers/footers)."""
    if not pages:
        return ImproveResult([], 0, 0.0)

    # pass 1: frequency of edge lines (first/last 2 of each page)
    freq: Counter[str] = Counter()
    for page in pages:
        lines = page.splitlines()
        edge = lines[:2] + (lines[-2:] if len(lines) > 2 else [])
        for ln in {_line_fingerprint(l) for l in edge if l.strip()}:
            freq[ln] += 1
    n_pages = len(pages)
    repeated = {
        fp for fp, c in freq.items()
        if n_pages >= 3 and c >= max(2, int(n_pages * repeat_frac)) and len(fp) > 2
    }

    removed = 0
    out_pages: list[str] = []
    for page in pages:
        kept: list[str] = []
        lines = page.splitlines()
        for i, ln in enumerate(lines):
            s = ln.strip()
            if not s:
                kept.append(ln)
                continue
            near_edge = i < 2 or i >= len(lines) - 2
            if near_edge and _PAGE_NUMBER.match(s):
                removed += 1
                continue
            # sentence-like prose is protected even when repeated: a
            # running header is short and rarely ends a sentence
            prose = len(s) > 40 and s.endswith((".", "?", "!"))
            if near_edge and not prose and _line_fingerprint(ln) in repeated:
                removed += 1
                continue
            if any(p.match(s) for p in _WATERMARK_PATTERNS):
                removed += 1
                continue
            kept.append(ln)
        out_pages.append("\n".join(kept).strip())

    text = "\n\n".join(out_pages)
    rep = score_text(text, num_pages=n_pages)
    return ImproveResult(out_pages, removed, rep.score)


def improve_extraction(text: str, num_pages: int = 1) -> str:
    """Single-string convenience (reference module fn
    ``extraction_improver.py:668``)."""
    pages = text.split("\n\n") if num_pages <= 1 else text.split("\f")
    return "\n\n".join(improve_pages(pages).pages)

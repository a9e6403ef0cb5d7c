"""Citation and reference-entry extraction.

The port's own copy of ``arxiv_rag_tpu/pipeline/citations.py``.

Behavioral parity with the reference's citation layer
(``text_processor.py:540-693``): in-text bracket (``[12]``, ``[3,7]``,
``[1-4]``) and author-year (``(Smith et al., 2023)``) citations with a
context window and section/page attribution; reference-list entry
parsing with author/title/year/arXiv-id heuristics.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from arxiv_rag_tpu_torch.pipeline.sections import SectionMap

BRACKET_CITE = re.compile(r"\[(\d{1,3}(?:\s*[,–-]\s*\d{1,3})*)\]")
AUTHOR_YEAR_CITE = re.compile(
    r"\(((?:[A-Z][A-Za-z'’\-]+)(?:\s+(?:and|&)\s+[A-Z][A-Za-z'’\-]+|\s+et\s+al\.?)?,?\s+(19|20)\d{2}[a-z]?)\)"
)
REF_ENTRY_LINE = re.compile(r"^\s*\[(\d{1,3})\]\s+(.*)$")
ARXIV_ID = re.compile(r"arXiv[:\s]*(\d{4}\.\d{4,5})(v\d+)?", re.IGNORECASE)
YEAR = re.compile(r"\b(19|20)\d{2}[a-z]?\b")
CONTEXT_CHARS = 80


@dataclass
class Citation:
    raw: str
    keys: list[str]
    start: int
    end: int
    context: str
    section: str = ""
    page: int = 0


@dataclass
class ReferenceEntry:
    number: int
    raw: str
    authors: str = ""
    title: str = ""
    year: int | None = None
    arxiv_id: str = ""


def _expand_keys(body: str) -> list[str]:
    """'3,7' → ['3','7']; '1-4' → ['1','2','3','4']."""
    keys: list[str] = []
    for part in re.split(r"\s*,\s*", body):
        m = re.match(r"(\d+)\s*[–-]\s*(\d+)$", part.strip())
        if m:
            lo, hi = int(m.group(1)), int(m.group(2))
            if 0 < hi - lo <= 50:
                keys.extend(str(i) for i in range(lo, hi + 1))
                continue
        keys.append(part.strip())
    return keys


def extract_citations(
    text: str, section_map: SectionMap | None = None
) -> list[Citation]:
    out: list[Citation] = []
    for pat, keyer in (
        (BRACKET_CITE, lambda m: _expand_keys(m.group(1))),
        (AUTHOR_YEAR_CITE, lambda m: [m.group(1)]),
    ):
        for m in pat.finditer(text):
            lo = max(0, m.start() - CONTEXT_CHARS)
            hi = min(len(text), m.end() + CONTEXT_CHARS)
            cit = Citation(
                raw=m.group(0),
                keys=keyer(m),
                start=m.start(),
                end=m.end(),
                context=text[lo:hi].replace("\n", " ").strip(),
            )
            if section_map is not None:
                cit.section = section_map.section_at(m.start())
                cit.page = section_map.page_at(m.start())
            out.append(cit)
    out.sort(key=lambda c: c.start)
    return out


def parse_reference_entries(references_text: str) -> list[ReferenceEntry]:
    """Parse a references section into numbered entries. Multi-line
    entries are joined until the next ``[n]``."""
    entries: list[ReferenceEntry] = []
    current: list[str] = []
    number = None
    for line in references_text.split("\n"):
        m = REF_ENTRY_LINE.match(line)
        if m:
            if number is not None:
                entries.append(_parse_entry(number, " ".join(current)))
            number = int(m.group(1))
            current = [m.group(2)]
        elif number is not None and line.strip():
            current.append(line.strip())
    if number is not None:
        entries.append(_parse_entry(number, " ".join(current)))
    return entries


def _parse_entry(number: int, raw: str) -> ReferenceEntry:
    entry = ReferenceEntry(number=number, raw=raw)
    m = ARXIV_ID.search(raw)
    if m:
        entry.arxiv_id = m.group(1)
    ym = YEAR.search(raw)
    if ym:
        entry.year = int(ym.group(0)[:4])
    # authors: leading span up to the first period that isn't an initial
    head = raw.split(". ")
    if head:
        candidate = head[0]
        if len(candidate) < 120 and ("," in candidate or " and " in candidate
                                     or "et al" in candidate):
            entry.authors = candidate.strip()
            rest = raw[len(candidate) + 2 :]
        else:
            rest = raw
        # title: quoted, or the next sentence-ish span
        qm = re.search(r"[“\"](.+?)[”\"]", raw)
        if qm:
            entry.title = qm.group(1).strip().rstrip(",.")
        else:
            tm = re.match(r"\s*(.+?)(?:\.\s|\.$)", rest)
            if tm:
                entry.title = tm.group(1).strip()
    return entry

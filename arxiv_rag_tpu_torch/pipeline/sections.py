"""Section extraction with char offsets and page mapping.

The port's own copy of ``arxiv_rag_tpu/pipeline/sections.py``.

Behavioral parity with TextProcessor.extract_sections
(``text_processor.py:169-499``): recognize ~30 canonical section
keywords plus numbered (``3. Methods``), Roman (``IV. RESULTS``) and
ALL-CAPS heading forms (:210-238); normalize fuzzy names to a canonical
taxonomy (:330-371); detect the references section from ``[1]``-style
entries even without a heading (:375-401); cap the scan at 5000 lines
(:253-254); track char offsets per section and map them to pages by
binary search over page start offsets (:461-499, mirrored in
``worker.py:563-617``).
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

CANONICAL = [
    "abstract", "introduction", "background", "related work", "preliminaries",
    "motivation", "problem statement", "theory", "methods", "methodology",
    "approach", "model", "architecture", "implementation", "system design",
    "experiments", "experimental setup", "evaluation", "results", "analysis",
    "ablation", "discussion", "limitations", "future work", "conclusion",
    "acknowledgments", "references", "appendix", "broader impact",
    "ethics statement",
]

_NORMALIZE = {
    "introduction and motivation": "introduction",
    "related works": "related work",
    "prior work": "related work",
    "literature review": "related work",
    "method": "methods",
    "proposed method": "methods",
    "proposed approach": "approach",
    "our approach": "approach",
    "materials and methods": "methods",
    "experimental results": "results",
    "results and discussion": "results",
    "experiments and results": "experiments",
    "empirical evaluation": "evaluation",
    "conclusions": "conclusion",
    "concluding remarks": "conclusion",
    "summary": "conclusion",
    "acknowledgements": "acknowledgments",
    "acknowledgement": "acknowledgments",
    "acknowledgment": "acknowledgments",
    "bibliography": "references",
    "appendices": "appendix",
    "supplementary material": "appendix",
    "ablation study": "ablation",
    "ablation studies": "ablation",
}

_KEYWORDS = sorted(set(CANONICAL) | set(_NORMALIZE), key=len, reverse=True)
_KW_ALT = "|".join(re.escape(k) for k in _KEYWORDS)

HEADING_RES = [
    # "3. Methods", "3 Methods", "3.1 Ablation"
    re.compile(rf"^\s*(\d+(?:\.\d+)*)\.?\s+({_KW_ALT})\s*:?\s*$", re.IGNORECASE),
    # "IV. RESULTS"
    re.compile(rf"^\s*([IVXLC]+)\.\s+({_KW_ALT})\s*:?\s*$", re.IGNORECASE),
    # bare keyword line: "Introduction", "ABSTRACT:"
    re.compile(rf"^\s*({_KW_ALT})\s*:?\s*$", re.IGNORECASE),
]
REF_ENTRY = re.compile(r"^\s*\[\d{1,3}\]\s+\S")
MAX_SCAN_LINES = 5000


@dataclass
class Section:
    name: str
    start_char: int
    end_char: int
    start_line: int
    page: int = 0
    heading: str = ""


@dataclass
class SectionMap:
    sections: list[Section] = field(default_factory=list)
    page_offsets: list[int] = field(default_factory=list)

    def section_at(self, char_offset: int) -> str:
        """Binary-search the section containing a char offset (the
        chunk→section mapping, ``worker.py:563-617``)."""
        starts = [s.start_char for s in self.sections]
        i = bisect.bisect_right(starts, char_offset) - 1
        return self.sections[i].name if i >= 0 else ""

    def page_at(self, char_offset: int) -> int:
        """1-based page number (0 = unknown/no page info)."""
        if not self.page_offsets:
            return 0
        return max(1, bisect.bisect_right(self.page_offsets, char_offset))


def normalize_section_name(raw: str) -> str:
    name = re.sub(r"\s+", " ", raw.strip().lower()).rstrip(":")
    return _NORMALIZE.get(name, name)


def extract_sections(
    text: str, page_texts: list[str] | None = None, page_join: str = ""
) -> SectionMap:
    """Scan headings (≤5000 lines), return sections with char spans and
    page numbers.

    ``page_join`` is the separator ``text`` was joined with (the runner
    uses "\n\n"); omitting it drifts page attribution by len(sep) chars
    per page."""
    page_offsets: list[int] = []
    if page_texts:
        off = 0
        for pt in page_texts:
            page_offsets.append(off)
            off += len(pt) + len(page_join)

    lines = text.split("\n")
    sections: list[Section] = []
    offset = 0
    ref_started = False
    for line_no, line in enumerate(lines[:MAX_SCAN_LINES]):
        matched = None
        for pat in HEADING_RES:
            m = pat.match(line)
            if m:
                raw = m.group(m.lastindex)  # keyword group is always last
                matched = normalize_section_name(raw)
                break
        # headless references detection: first [1]-style entry after scan
        if matched is None and not ref_started and REF_ENTRY.match(line):
            window = lines[line_no : line_no + 4]
            if sum(bool(REF_ENTRY.match(w)) for w in window) >= 2:
                matched = "references"
        if matched == "references":
            ref_started = True
        if matched is not None:
            # ALL-CAPS prose guard: a heading line is short
            if len(line.strip()) <= 80:
                sections.append(
                    Section(
                        name=matched,
                        start_char=offset,
                        end_char=len(text),
                        start_line=line_no,
                        heading=line.strip(),
                    )
                )
        offset += len(line) + 1

    # close spans
    for cur, nxt in zip(sections, sections[1:]):
        cur.end_char = nxt.start_char
    # dedup: keep first occurrence of consecutive duplicates
    deduped: list[Section] = []
    for s in sections:
        if deduped and deduped[-1].name == s.name and s.start_char - deduped[-1].end_char == 0:
            deduped[-1].end_char = s.end_char
            continue
        deduped.append(s)

    smap = SectionMap(deduped, page_offsets)
    for s in smap.sections:
        s.page = smap.page_at(s.start_char)
    return smap

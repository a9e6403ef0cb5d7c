"""Cross-reference resolution: internal links inside a paper.

The port's own copy of ``arxiv_rag_tpu/pipeline/crossref.py``.

Parity with the reference's cross-reference pass
(``pdf_extractor.py:2197-3148``): find mentions like "see Section 3",
"as shown in Figure 2", "Table 1 reports", "Equation (4)", "Appendix A"
and resolve them to targets — section char offsets (via the section
map), figure/table labels (via extract.tables detections or textual
"Figure N" anchors), producing a link table the chunk metadata or a UI
can consume.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from arxiv_rag_tpu_torch.pipeline.sections import SectionMap

_MENTION = re.compile(
    r"\b(?P<kind>Section|Sec\.|Figure|Fig\.|Table|Tab\.|Equation|Eq\.|Appendix|Algorithm|Alg\.)"
    r"\s*\(?(?P<label>[0-9]+(?:\.[0-9]+)*[a-z]?|[A-Z])\)?",
)
_ANCHOR = re.compile(
    r"^(?:(?P<akind>Figure|Fig\.|Table|Tab\.|Algorithm|Alg\.)\s*(?P<alabel>\d+[a-z]?))\s*[:.]",
    re.MULTILINE,
)

_KIND_NORM = {
    "sec.": "section", "section": "section",
    "fig.": "figure", "figure": "figure",
    "tab.": "table", "table": "table",
    "eq.": "equation", "equation": "equation",
    "appendix": "appendix",
    "algorithm": "algorithm", "alg.": "algorithm",
}


@dataclass
class CrossRef:
    kind: str  # section | figure | table | equation | appendix | algorithm
    label: str
    mention_start: int
    mention_end: int
    context: str
    resolved: bool = False
    target_offset: int | None = None  # char offset of the target, if known
    target_section: str = ""


@dataclass
class CrossRefTable:
    refs: list[CrossRef] = field(default_factory=list)

    @property
    def resolved_count(self) -> int:
        return sum(1 for r in self.refs if r.resolved)

    def by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.refs:
            out[r.kind] = out.get(r.kind, 0) + 1
        return out


def _section_targets(text: str, smap: SectionMap | None) -> dict[str, int]:
    """Map numbered-section labels ('3', '3.1') to char offsets."""
    targets: dict[str, int] = {}
    for m in re.finditer(r"^(?:(\d+(?:\.\d+)*))[.\s]+[A-Z]", text, re.MULTILINE):
        targets.setdefault(m.group(1), m.start())
    if smap is not None:
        for s in smap.sections:
            m = re.match(r"(\d+(?:\.\d+)*)", s.heading or "")
            if m:
                targets.setdefault(m.group(1), s.start_char)
    return targets


def _anchor_targets(text: str) -> dict[tuple[str, str], int]:
    """('figure', '2') -> offset of the 'Figure 2:' caption anchor."""
    out: dict[tuple[str, str], int] = {}
    for m in _ANCHOR.finditer(text):
        kind = _KIND_NORM[m.group("akind").lower()]
        out.setdefault((kind, m.group("alabel")), m.start())
    return out


def extract_crossrefs(
    text: str,
    smap: SectionMap | None = None,
    context_chars: int = 60,
) -> CrossRefTable:
    sections = _section_targets(text, smap)
    anchors = _anchor_targets(text)
    table = CrossRefTable()
    for m in _MENTION.finditer(text):
        kind = _KIND_NORM[m.group("kind").lower()]
        label = m.group("label")
        # caption anchors are definitions, not mentions — skip a mention
        # that IS its own anchor
        if anchors.get((kind, label)) == m.start():
            continue
        lo = max(0, m.start() - context_chars)
        hi = min(len(text), m.end() + context_chars)
        ref = CrossRef(
            kind=kind,
            label=label,
            mention_start=m.start(),
            mention_end=m.end(),
            context=text[lo:hi].replace("\n", " ").strip(),
        )
        if kind == "section" and label in sections:
            ref.resolved = True
            ref.target_offset = sections[label]
        elif (kind, label) in anchors:
            ref.resolved = True
            ref.target_offset = anchors[(kind, label)]
        if ref.resolved and smap is not None and ref.target_offset is not None:
            ref.target_section = smap.section_at(ref.target_offset)
        table.refs.append(ref)
    return table

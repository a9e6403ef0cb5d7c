"""Math/formula detection and normalization.

The port's own copy of ``arxiv_rag_tpu/pipeline/formulas.py``.

Behavioral parity with the reference FormulaProcessor
(``2-extraction/formula_processor.py``): detect LaTeX display/inline
math, ``var = expr`` equations, unicode-math lines and sub/superscript
runs (:40-122); normalize operator and Greek-letter spacing, compact
sub/superscripts (:169-201); and a placeholder preserve/restore pair so
cleaning passes can't mangle math (:223-258).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

DISPLAY_MATH = re.compile(r"\$\$[^$]+\$\$|\\\[[\s\S]*?\\\]|\\begin\{(equation|align|gather)\*?\}[\s\S]*?\\end\{\1\*?\}")
INLINE_MATH = re.compile(r"(?<!\$)\$[^$\n]+\$(?!\$)|\\\([\s\S]*?\\\)")
VAR_EQUATION = re.compile(r"\b[A-Za-z]\w{0,8}\s*(?:=|≈|≤|≥|∝|≠)\s*[^\s,.;]{1,80}")
GREEK = "αβγδεζηθικλμνξοπρστυφχψωΓΔΘΛΞΠΣΦΨΩ"
UNICODE_MATH_CHARS = set("∑∏∫∂∇√∞±×÷≤≥≠≈∈∉⊂⊆∪∩→⇒⇔∀∃" + GREEK)
SUBSUPER = re.compile(r"[A-Za-z]\s*[_^]\s*\{?\w+\}?")

# private-use-area sentinels: survive the cleaner's control-char strip
# (NUL sentinels were deleted by CONTROL_CHARS, destroying every formula)
_PLACEHOLDER = "\ue000MATH{}\ue001"


@dataclass
class Formula:
    kind: str  # display | inline | equation | unicode | subsuper
    text: str
    start: int
    end: int


def detect_formulas(text: str) -> list[Formula]:
    """All spans that look like math, non-overlapping, position-sorted."""
    found: list[Formula] = []
    for kind, pattern in (
        ("display", DISPLAY_MATH),
        ("inline", INLINE_MATH),
        ("equation", VAR_EQUATION),
        ("subsuper", SUBSUPER),
    ):
        for m in pattern.finditer(text):
            found.append(Formula(kind, m.group(0), m.start(), m.end()))
    # unicode-math-dense lines
    offset = 0
    for line in text.split("\n"):
        n_math = sum(ch in UNICODE_MATH_CHARS for ch in line)
        if n_math >= 3 and n_math >= len(line.strip()) * 0.15 and line.strip():
            found.append(Formula("unicode", line, offset, offset + len(line)))
        offset += len(line) + 1
    found.sort(key=lambda f: (f.start, -(f.end - f.start)))
    out: list[Formula] = []
    last_end = -1
    for f in found:
        if f.start >= last_end:
            out.append(f)
            last_end = f.end
    return out


_OP_SPACING = re.compile(r"\s*([=+\-±×÷<>≤≥≈≠])\s*")
_GREEK_RUN = re.compile(rf"([{GREEK}])\s+(?=[{GREEK}])")
_SUB_COMPACT = re.compile(r"([A-Za-z])\s+([_^])\s*")
_BRACE_COMPACT = re.compile(r"([_^])\s*\{\s*(\w+)\s*\}")


def normalize_formula(text: str) -> str:
    """Canonical spacing inside a math span: single spaces around binary
    operators, no stray gaps in sub/superscripts, Greek runs joined."""
    out = _OP_SPACING.sub(r" \1 ", text)
    out = _SUB_COMPACT.sub(r"\1\2", out)
    out = _BRACE_COMPACT.sub(r"\1{\2}", out)
    out = _GREEK_RUN.sub(r"\1", out)
    return re.sub(r"  +", " ", out).strip()


def protect_formulas(text: str) -> tuple[str, list[str]]:
    """Swap math spans for placeholders before lossy cleaning passes."""
    saved: list[str] = []

    def _stash(m: re.Match) -> str:
        saved.append(m.group(0))
        return _PLACEHOLDER.format(len(saved) - 1)

    protected = DISPLAY_MATH.sub(_stash, text)
    protected = INLINE_MATH.sub(_stash, protected)
    return protected, saved


def restore_formulas(text: str, saved: list[str]) -> str:
    for i, s in enumerate(saved):
        text = text.replace(_PLACEHOLDER.format(i), s)
    return text


def improve_formula_formatting(text: str) -> str:
    """Whole-document formula cleanup: normalize every detected math span
    in place (the reference's module-level entry,
    ``formula_processor.py:261-325``)."""
    spans = [f for f in detect_formulas(text) if f.kind in ("display", "inline", "equation")]
    if not spans:
        return text
    parts: list[str] = []
    cursor = 0
    for f in spans:
        parts.append(text[cursor : f.start])
        parts.append(normalize_formula(f.text))
        cursor = f.end
    parts.append(text[cursor:])
    return "".join(parts)

"""Table detection from positioned text spans.

The port's own copy of ``arxiv_rag_tpu/pipeline/extract/tables.py``.

The reference detects tables with pdfplumber heuristics and regex
passes (``pdf_extractor.py:912-1578``, ``save_extractions.py:122-149``).
This build already has device coordinates for every span (pdftext.py),
so tables are found geometrically:

- group spans into rows by baseline y;
- a *table row* has ≥3 cells separated by clear x-gaps;
- ≥3 consecutive table rows whose cell x-positions align (within a
  tolerance) form a table; cells snap to the union of column starts.

Also provides AdaptiveChunking's layout analysis (reference:
``extraction_optimizer.py:557-830``): per-page complexity signals →
recommended chunking strategy.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .pdftext import Span


@dataclass
class Table:
    page: int
    rows: list[list[str]]
    y_top: float
    y_bottom: float

    @property
    def n_cols(self) -> int:
        return max((len(r) for r in self.rows), default=0)


def _group_rows(spans: list[Span]) -> list[list[Span]]:
    rows: dict[float, list[Span]] = {}
    for s in spans:
        if not s.text.strip():
            continue
        key = round(s.y / max(s.size * 0.45, 2.0))
        rows.setdefault(key, []).append(s)
    ordered = sorted(rows.values(), key=lambda r: -r[0].y)
    for r in ordered:
        r.sort(key=lambda s: s.x)
    return ordered


def _row_cells(row: list[Span], gap_factor: float = 1.5) -> list[tuple[float, str]]:
    """Merge adjacent spans, split at big x-gaps → (x_start, text) cells."""
    cells: list[tuple[float, str]] = []
    cur_x, cur_text, prev_end = None, "", None
    for s in row:
        gap = (s.x - prev_end) if prev_end is not None else 0.0
        if cur_x is None:
            cur_x, cur_text = s.x, s.text
        elif gap > max(gap_factor * s.size, 6.0):
            cells.append((cur_x, cur_text.strip()))
            cur_x, cur_text = s.x, s.text
        else:
            sep = " " if gap > 0.15 * s.size else ""
            cur_text += sep + s.text
        prev_end = max(s.end_x, s.x)
    if cur_x is not None and cur_text.strip():
        cells.append((cur_x, cur_text.strip()))
    return cells


def detect_tables(
    spans: list[Span],
    page: int = 1,
    min_rows: int = 3,
    min_cols: int = 3,
    align_tol: float = 12.0,
) -> list[Table]:
    """Geometric table detection over one page's spans."""
    rows = _group_rows(spans)
    cell_rows = [(_row_cells(r), r) for r in rows]

    tables: list[Table] = []
    run: list[tuple[list[tuple[float, str]], list[Span]]] = []

    def aligned(a: list[tuple[float, str]], b: list[tuple[float, str]]) -> bool:
        if abs(len(a) - len(b)) > 1:
            return False
        hits = 0
        for xa, _ in a:
            if any(abs(xa - xb) <= align_tol for xb, _ in b):
                hits += 1
        return hits >= min(len(a), len(b)) - 1

    def flush() -> None:
        if len(run) >= min_rows:
            texts = [[t for _, t in cells] for cells, _ in run]
            ys = [r[0].y for _, r in run]
            tables.append(Table(page=page, rows=texts, y_top=max(ys), y_bottom=min(ys)))
        run.clear()

    for cells, row in cell_rows:
        if len(cells) >= min_cols:
            if run and not aligned(run[-1][0], cells):
                flush()
            run.append((cells, row))
        else:
            flush()
    flush()
    return tables


# ---------------------------------------------------------------------------
# footnotes
# ---------------------------------------------------------------------------

_FOOTNOTE_MARK = None  # compiled lazily below


def detect_footnotes(
    spans: list[Span],
    page_height: float = 792.0,
    bottom_frac: float = 0.18,
    size_ratio: float = 0.9,
) -> list[dict]:
    """Footnotes from span geometry: bottom-of-page lines set in a
    smaller face, starting with a marker (digit, *, †).

    Reference behavior: ``pdf_extractor.py:3149-3533`` (regex-driven);
    here position + font size carry the signal.
    """
    import re

    global _FOOTNOTE_MARK
    if _FOOTNOTE_MARK is None:
        _FOOTNOTE_MARK = re.compile(r"^\s*(\d{1,2}|[*†‡§¶])\s*\S")

    body = [s for s in spans if s.text.strip()]
    if len(body) < 5:
        return []
    sizes = sorted(s.size for s in body)
    median_size = sizes[len(sizes) // 2]
    cutoff_y = page_height * bottom_frac
    small_low = [
        s for s in body if s.y <= cutoff_y and s.size <= median_size * size_ratio
    ]
    if not small_low:
        return []
    out: list[dict] = []
    for _, x, text in _assemble_lines_pub(small_low):
        m = _FOOTNOTE_MARK.match(text)
        if m and len(text) > 8:
            out.append({"marker": m.group(1), "text": text.strip(), "x": x})
    return out


def _assemble_lines_pub(spans: list[Span]) -> list[tuple[float, float, str]]:
    from .pdftext import _assemble_lines

    return _assemble_lines(spans)


# ---------------------------------------------------------------------------
# adaptive chunking (layout → strategy)
# ---------------------------------------------------------------------------


@dataclass
class LayoutProfile:
    pages_sampled: int = 0
    two_column_pages: int = 0
    table_pages: int = 0
    math_density: float = 0.0
    avg_chars_per_page: float = 0.0
    recommended_strategy: str = "fixed"
    reasons: list[str] = field(default_factory=list)


def analyze_layout(
    page_spans: list[list[Span]],
    page_width: float = 612.0,
) -> LayoutProfile:
    """Per-document layout profile → chunking strategy recommendation
    (AdaptiveChunking parity, ``extraction_optimizer.py:557-830``)."""
    import re

    prof = LayoutProfile(pages_sampled=len(page_spans))
    if not page_spans:
        return prof
    math_chars = 0
    total_chars = 0
    mid = page_width / 2.0
    math_re = re.compile(r"[=∑∫√±≤≥∈∂λαβγθμσ]")
    for spans in page_spans:
        text = " ".join(s.text for s in spans)
        total_chars += len(text)
        math_chars += len(math_re.findall(text))
        left = sum(1 for s in spans if s.x < mid * 0.9)
        right = sum(1 for s in spans if s.x >= mid * 0.9)
        if len(spans) >= 12 and right >= 0.25 * len(spans) and left >= 0.25 * len(spans):
            prof.two_column_pages += 1
        if detect_tables(spans):
            prof.table_pages += 1
    prof.math_density = math_chars / max(1, total_chars)
    prof.avg_chars_per_page = total_chars / len(page_spans)

    # strategy pick: tables/math-heavy → fixed (structure-agnostic,
    # stable offsets); clean single-column prose → sentence; long,
    # discursive multi-section prose → semantic
    if prof.table_pages > 0.3 * prof.pages_sampled or prof.math_density > 0.02:
        prof.recommended_strategy = "fixed"
        prof.reasons.append("table/math heavy: sentence boundaries unreliable")
    elif prof.avg_chars_per_page > 1500 and prof.two_column_pages < 0.5 * prof.pages_sampled:
        prof.recommended_strategy = "semantic"
        prof.reasons.append("long single-column prose: topic boundaries useful")
    else:
        prof.recommended_strategy = "sentence"
        prof.reasons.append("default prose profile")
    return prof

"""Text cleaning — the TextProcessor.clean contract.

The port's own copy of ``arxiv_rag_tpu/pipeline/clean.py``.

Behavioral parity with ``text_processor.py:84-167``: strip control
characters (:98-102), remove arXiv identifier headers (:106-112) and
repeated running titles (:114-142), drop standalone page numbers
(:144-152), normalize whitespace (:154-161), then run the formula
improvement hook (:163-165). Math spans are placeholder-protected
through the lossy passes (pipeline/formulas.py), which the reference
does inside its formula processor.

The cleaner also runs the extraction-artifact repair family the
reference applies at extraction time (``pdf_extractor.py:64-154``'s
post-processing regex army, :7457-7593 ``_post_process_extracted_text``)
— consolidated here as ``polish_extracted_text`` so every extractor
strategy benefits from one tested pass instead of each reimplementing
it.
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass, field

from arxiv_rag_tpu_torch.pipeline.formulas import (
    improve_formula_formatting,
    protect_formulas,
    restore_formulas,
)

CONTROL_CHARS = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f�]")
ARXIV_HEADERS = [
    re.compile(r"^\s*arXiv:\s*\d{4}\.\d{4,5}(v\d+)?\s*(\[[\w.\-]+\])?.*$", re.MULTILINE),
    re.compile(r"^\s*arXiv:[\w\-./]+\s+\d{1,2}\s+\w{3,9}\s+\d{4}\s*$", re.MULTILINE),
    re.compile(r"^\s*Preprint\.?\s+Under review\.?\s*$", re.IGNORECASE | re.MULTILINE),
]
PAGE_NUMBER = re.compile(r"^\s*(?:page\s+)?\d{1,4}(\s+of\s+\d{1,4})?\s*$",
                         re.IGNORECASE | re.MULTILINE)


@dataclass
class CleanStats:
    control_chars: int = 0
    headers_removed: int = 0
    repeated_lines_removed: int = 0
    page_numbers_removed: int = 0


@dataclass
class TextCleaner:
    remove_headers: bool = True
    remove_page_numbers: bool = True
    improve_formulas: bool = True
    polish: bool = True  # extraction-artifact repair (polish_extracted_text)
    repeat_threshold: int = 3  # a line appearing on >= this many "pages" is a running header
    stats: CleanStats = field(default_factory=CleanStats)

    def clean(self, text: str, page_texts: list[str] | None = None) -> str:
        self.stats = CleanStats()
        protected, saved = protect_formulas(text)

        n = len(CONTROL_CHARS.findall(protected))
        self.stats.control_chars = n
        protected = CONTROL_CHARS.sub("", protected)

        if self.remove_headers:
            for pat in ARXIV_HEADERS:
                protected, k = pat.subn("", protected)
                self.stats.headers_removed += k
            protected = self._remove_repeated_lines(protected, page_texts)

        if self.remove_page_numbers:
            protected, k = PAGE_NUMBER.subn("", protected)
            self.stats.page_numbers_removed = k

        if self.polish:
            # formula spans are still placeholder-protected here, so the
            # typography/identifier repairs can't corrupt math
            protected = polish_extracted_text(protected)
        protected = self._normalize_whitespace(protected)
        text = restore_formulas(protected, saved)
        if self.improve_formulas:
            text = improve_formula_formatting(text)
        return text

    def _remove_repeated_lines(self, text: str, page_texts: list[str] | None) -> str:
        """Running titles/headers repeat near-identically across pages
        (reference counts repeated title lines, ``text_processor.py:114-142``).
        Without page boundaries, fall back to counting identical short
        lines across the document."""
        lines = text.split("\n")
        counts = Counter(
            ln.strip().lower() for ln in lines
            if 5 <= len(ln.strip()) <= 120 and not ln.strip()[0].isdigit()
        )
        threshold = (
            max(self.repeat_threshold, (len(page_texts) or 0) // 2)
            if page_texts
            else max(self.repeat_threshold, 3)
        )
        repeated = {
            ln for ln, c in counts.items()
            if c >= threshold and not _looks_like_prose(ln)
        }
        if not repeated:
            return text
        out = []
        seen_once: set[str] = set()
        for ln in lines:
            key = ln.strip().lower()
            if key in repeated:
                if key in seen_once:
                    self.stats.repeated_lines_removed += 1
                    continue
                seen_once.add(key)  # keep the first occurrence (real title)
            out.append(ln)
        return "\n".join(out)

    @staticmethod
    def _normalize_whitespace(text: str) -> str:
        text = text.replace(" ", " ").replace("\t", " ")
        text = re.sub(r" {2,}", " ", text)
        text = re.sub(r" +\n", "\n", text)
        text = re.sub(r"\n{3,}", "\n\n", text)
        return text.strip()


def _looks_like_prose(line: str) -> bool:
    """Sentences (ending punctuation, many words) are never headers."""
    words = line.split()
    return len(words) > 12 or line.endswith((".", "!", "?", ";", ","))


def dehyphenate(text: str) -> str:
    """Join words broken across line ends: ``convolu-\\ntional`` →
    ``convolutional`` (extraction post-processing family,
    ``pdf_extractor.py:64-154`` regex passes)."""
    return re.sub(r"(\w{2,})-\s*\n\s*(\w{2,})", r"\1\2", text)


# Extraction-artifact repair passes (the behavioral contract of the
# reference's post-processing army, ``pdf_extractor.py:64-154``), written
# fresh as one ordered table. Deliberately NOT replicated from there:
# - dash swaps (its #26 rewrites " - " to an en dash, mangling minus
#   signs and ranges);
# - generic operator-spacing passes (#4/#31 fight the formula
#   protection/normalization this pipeline already does in formulas.py);
# - greedy quote tightening (#10 matches across arbitrarily long spans).
_POLISH_PASSES = (
    # broken URLs/emails: glue "example . com" / "user @ domain". Single
    # SPACES only and a lowercase/digit continuation: \s+ matched
    # newlines, so "end .\nNext" (a plain spaced sentence period, common
    # in PDF extractions) was glued across the sentence boundary; prose
    # after ". " is capitalized while domain labels/TLDs are not. The
    # lookahead keeps overlapping repairs working ("www . ex . com").
    (re.compile(r"([A-Za-z0-9]) ([@.]) (?=[a-z0-9])"), r"\1\2"),
    # citation brackets: [ 12 ] -> [12]
    (re.compile(r"\[\s+(\d+)\s*\]|\[\s*(\d+)\s+\]"), lambda m: f"[{m.group(1) or m.group(2)}]"),
    # references broken across a line break: "Figure\n 3" -> "Figure 3"
    (re.compile(r"\b(Figure|Table|Equation|Section|Algorithm|Fig\.|Tab\.)\s*\n\s*(\d+)",
                re.IGNORECASE), r"\1 \2"),
    # spaced abbreviations: "i. e." -> "i.e."
    (re.compile(r"\b([a-z])\.\s+([a-z])\.(?=[\s,)])"), r"\1.\2."),
    # decimals and percentages: "3 . 14" -> "3.14", "95 %" -> "95%"
    (re.compile(r"(\d)\s+\.\s+(\d)"), r"\1.\2"),
    (re.compile(r"(\d)\s+%"), r"\1%"),
    # NOT ported: the reference's digit-group join (#24, "(\d)\s+(\d{3})\b")
    # corrupts ordinary prose — "In 2014 500 participants" -> "2014500" —
    # and \s+ crosses line breaks; a split thousands group is rarer than
    # adjacent independent numbers, so the pass loses more than it fixes
    # parenthesis/bracket inner spacing: "( x )" -> "(x)"
    (re.compile(r"\(\s+([^()\n]*?)\s+\)"), r"(\1)"),
    (re.compile(r"\[\s+([^\[\]\n]*?)\s+\]"), r"[\1]"),
    # broken LaTeX commands: "\\ alpha" -> "\\alpha", "\\ {" -> "\\{"
    (re.compile(r"\\\s+([a-zA-Z]+)"), r"\\\1"),
    (re.compile(r"\\\s+\{"), r"\\{"),
    # bullets to a uniform list marker
    (re.compile(r"^\s*[•▪‣]\s+", re.MULTILINE), "- "),
    # spaced sub/superscripts: "x _ i" -> "x_i", "x ^ { 2 }" -> "x^2"
    # (brace-trailing whitespace consumed only WITH the brace, else the
    # pass would glue the following word on)
    (re.compile(r"([A-Za-z0-9])\s*_\s*(?:\{\s*)?([A-Za-z0-9])(?:\s*\})?"), r"\1_\2"),
    (re.compile(r"([A-Za-z0-9])\s*\^\s*(?:\{\s*)?([A-Za-z0-9])(?:\s*\})?"), r"\1^\2"),
    # version tags: "v 2" -> "v2"
    (re.compile(r"\bv\s+(\d+)\b"), r"v\1"),
)

_HTML_ENTITY = re.compile(r"&(?:amp|lt|gt|quot|#\d+|#x[0-9a-fA-F]+);")


def polish_extracted_text(text: str) -> str:
    """Repair extraction artifacts: ligatures, line-break hyphenation,
    HTML entities, spaced punctuation/identifiers (see _POLISH_PASSES).
    Runs inside TextCleaner.clean while formula spans are protected, so
    none of these touch real math."""
    import html

    text = fix_ligatures(text)
    text = dehyphenate(text)
    if _HTML_ENTITY.search(text):
        text = html.unescape(text)
    for pat, repl in _POLISH_PASSES:
        text = pat.sub(repl, text)
    return text


def fix_ligatures(text: str) -> str:
    """Common PDF ligature/smart-quote codepoints → ASCII.

    Keys are written as unicode escapes: quote literals in a dict
    display previously parsed as an accidental triple-quote, producing
    a corrupting mapping and ASCII self-maps instead of the documented
    curly-quote normalization."""
    table = {
        "ﬁ": "fi", "ﬂ": "fl", "ﬀ": "ff",
        "ﬃ": "ffi", "ﬄ": "ffl",
        "–": "-", "—": "--",
        "‘": "'", "’": "'",
        "“": '"', "”": '"',
    }
    for k, v in table.items():
        text = text.replace(k, v)
    return text

"""Paper metadata extraction: title / abstract / authors / identifiers.

The port's own copy of ``arxiv_rag_tpu/pipeline/metadata.py``.

Behavioral parity with TextProcessor.extract_metadata
(``text_processor.py:695-801``) plus the extractor's identifier passes
(``pdf_extractor.py:3534-4130``: DOI, arXiv id, URLs, emails, ISBN,
ORCID) and multi-strategy abstract detection (``:5930-6322``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

DOI = re.compile(r"\b10\.\d{4,9}/[-._;()/:A-Za-z0-9]+\b")
ARXIV_ID = re.compile(r"arXiv[:\s]*(\d{4}\.\d{4,5})(v\d+)?", re.IGNORECASE)
URL = re.compile(r"https?://[^\s<>\)\]]+")
EMAIL = re.compile(r"\b[\w.+-]+@[\w-]+\.[\w.-]+\b")
ISBN = re.compile(r"\bISBN[:\s]*((?:97[89][- ]?)?\d{1,5}[- ]?\d{1,7}[- ]?\d{1,7}[- ]?[\dX])\b", re.IGNORECASE)
ORCID = re.compile(r"\b\d{4}-\d{4}-\d{4}-\d{3}[\dX]\b")

ABSTRACT_HEAD = re.compile(r"^\s*abstract\s*[:.—-]?\s*$", re.IGNORECASE | re.MULTILINE)
ABSTRACT_INLINE = re.compile(r"^\s*abstract\s*[:.—-]\s*(\S.*)$", re.IGNORECASE | re.MULTILINE)
INTRO_HEAD = re.compile(r"^\s*(1\.?|I\.)?\s*introduction\s*$", re.IGNORECASE | re.MULTILINE)
AUTHOR_LINE = re.compile(
    r"^(?:[A-Z][\w'’\-.]+(?:\s+[A-Z][\w'’\-.]+){0,3})"
    r"(?:\s*(?:,|and|&)\s*[A-Z][\w'’\-.]+(?:\s+[A-Z][\w'’\-.]+){0,3})+\s*$"
)


@dataclass
class PaperMetadata:
    title: str = ""
    abstract: str = ""
    authors: list[str] = field(default_factory=list)
    emails: list[str] = field(default_factory=list)
    doi: str = ""
    arxiv_id: str = ""
    urls: list[str] = field(default_factory=list)
    isbns: list[str] = field(default_factory=list)
    orcids: list[str] = field(default_factory=list)


def extract_title(text: str) -> str:
    """First substantial line that isn't an arXiv header/identifier —
    tolerates titles wrapped over two lines."""
    lines = [ln.strip() for ln in text.split("\n")[:30]]
    picked: list[str] = []
    for ln in lines:
        if not ln or ARXIV_ID.search(ln) or URL.search(ln) or EMAIL.search(ln):
            if picked:
                break
            continue
        if len(ln) < 8 or ln.lower().startswith(("abstract", "preprint", "under review")):
            if picked:
                break
            continue
        if ln.isupper() and len(ln) < 12:  # running header fragment
            continue
        picked.append(ln)
        if len(" ".join(picked)) > 70 or len(picked) == 2:
            break
    return " ".join(picked).strip()


def extract_abstract(text: str) -> str:
    """Five strategies in priority order (reference ``:5930-6322``):
    inline 'Abstract: ...', heading + following block, block between
    title area and Introduction, first long paragraph, empty."""
    m = ABSTRACT_INLINE.search(text)
    if m:
        start = m.start(1)
        return _paragraph_from(text, start)
    m = ABSTRACT_HEAD.search(text)
    if m:
        return _paragraph_from(text, m.end())
    im = INTRO_HEAD.search(text)
    if im:
        head = text[: im.start()]
        paras = [p.strip() for p in re.split(r"\n\s*\n", head) if len(p.strip()) > 200]
        if paras:
            return re.sub(r"\s+", " ", paras[-1])
    for p in re.split(r"\n\s*\n", text[:8000]):
        p = p.strip()
        if len(p) > 300 and p.count(".") >= 3:
            return re.sub(r"\s+", " ", p)
    return ""


def _paragraph_from(text: str, start: int, max_chars: int = 3000) -> str:
    block = text[start : start + max_chars]
    stop = re.search(r"\n\s*\n|\n\s*(1\.?|I\.)?\s*introduction\b", block, re.IGNORECASE)
    if stop:
        block = block[: stop.start()]
    return re.sub(r"\s+", " ", block).strip()


def extract_authors(text: str, title: str = "") -> list[str]:
    """Author-looking lines between the title and the abstract."""
    head = text[:2500]
    if title:
        pos = head.find(title.split("\n")[0][:40])
        if pos >= 0:
            head = head[pos + len(title) :]
    am = ABSTRACT_HEAD.search(head) or ABSTRACT_INLINE.search(head)
    if am:
        head = head[: am.start()]
    authors: list[str] = []
    for ln in head.split("\n"):
        ln = ln.strip().rstrip("*†‡1234567890 ")
        if not ln or EMAIL.search(ln) or URL.search(ln):
            continue
        if AUTHOR_LINE.match(ln) and 2 <= len(ln.split()) <= 24:
            for name in re.split(r"\s*(?:,|and|&)\s*", ln):
                name = name.strip()
                if name and len(name.split()) <= 4 and name[0].isupper():
                    authors.append(name)
    return authors[:20]


def extract_metadata(text: str) -> PaperMetadata:
    md = PaperMetadata()
    md.title = extract_title(text)
    md.abstract = extract_abstract(text)
    md.authors = extract_authors(text, md.title)
    md.emails = sorted(set(EMAIL.findall(text[:5000])))
    dm = DOI.search(text)
    md.doi = dm.group(0) if dm else ""
    am = ARXIV_ID.search(text[:3000])
    md.arxiv_id = am.group(1) if am else ""
    md.urls = sorted(set(URL.findall(text)))[:50]
    md.isbns = sorted({m.group(1) for m in ISBN.finditer(text)})
    md.orcids = sorted(set(ORCID.findall(text)))
    return md

"""The port's in-repo PDF reader against the JAX package's: the same PDFs
(``tests/pdfgen.py``, the reference tests' fixtures, seeded byte
mutations as ``tests/test_pdf_fuzz.py`` makes them) give equal
``ExtractionResult.to_dict()`` (the one timing field,
``metadata["extract_seconds"]``, excepted), equal pages, spans, tables,
quality reports and improvements, the same error class on broken input,
and an extraction cache that either package reads from the other."""

import json
import random

import numpy as np
import pytest

from arxiv_rag_tpu.pipeline import extract as jext
from arxiv_rag_tpu.pipeline.extract import extractor as jextractor
from arxiv_rag_tpu.pipeline.extract import ocr as jocr
from arxiv_rag_tpu.pipeline.extract import pdftext as jpdftext
from arxiv_rag_tpu.pipeline.extract import tables as jtables

from arxiv_rag_tpu_torch.pipeline import extract as ext
from arxiv_rag_tpu_torch.pipeline.extract import extractor
from arxiv_rag_tpu_torch.pipeline.extract import ocr
from arxiv_rag_tpu_torch.pipeline.extract import pdftext
from arxiv_rag_tpu_torch.pipeline.extract import tables

from pdfgen import (
    content_stream_for_lines,
    make_pdf,
    mixed_quality_pdf,
    scanned_pdf,
    simple_text_pdf,
    text_pdf_with_figures,
)
from test_hard_paper import hard_paper_pdf
from test_ocr import FIG_TEXT, PAGE_TEXT, SCAN_TEXT
from test_tables import table_pdf

TIMING_FIELDS = ("extract_seconds",)  # metadata fields that hold wall-clock timings


def _random_pages(seed: int, n_pages: int) -> list[str]:
    rng = np.random.default_rng(seed)
    words = "dense retrieval encoder index kernel latency corpus token shard query".split()
    return [" ".join(" ".join(words[i] for i in rng.integers(0, len(words), 12)).capitalize()
                     + "." for _ in range(rng.integers(4, 12))) for _ in range(n_pages)]


def _two_columns() -> bytes:
    left = [(72, 700 - 12 * i, f"left{i} column text body") for i in range(10)]
    right = [(330, 700 - 12 * i, f"right{i} column text body") for i in range(10)]
    return make_pdf([content_stream_for_lines([v for pair in zip(left, right) for v in pair])])


FONT_DIFF = (b"<< /Type /Font /Subtype /Type1 /BaseFont /Custom "
             b"/FirstChar 65 /LastChar 67 /Widths [500 500 500] "
             b"/Encoding << /Differences [65 /alpha /beta /summation] >> >>")

PDFS = {
    "simple": simple_text_pdf(["Hello world from page one.", "And page two text."]),
    "xref_stream": simple_text_pdf(["Object stream flavored document."], xref_stream=True),
    "uncompressed": simple_text_pdf(["Plain uncompressed stream."], compress=False),
    "broken_startxref": simple_text_pdf(["Recovered text."]).replace(b"startxref",
                                                                      b"startxrEF"),
    "random_pages": simple_text_pdf(_random_pages(0, 5)),
    "tj_kern": make_pdf([b"BT /F1 10 Tf 72 700 Td [(Hello) -600 (world)] TJ ET"]),
    "two_columns": _two_columns(),
    "font_differences": make_pdf([b"BT /F1 10 Tf 72 700 Td (ABC) Tj ET"], font_dict=FONT_DIFF),
    "no_text": make_pdf([b"q 1 0 0 1 0 0 cm Q", b"q Q"]),
    "mixed_quality": mixed_quality_pdf(),
    "hard_paper": hard_paper_pdf(),
    "table": table_pdf(),
    "scanned": scanned_pdf([SCAN_TEXT, SCAN_TEXT.replace("scanned", "second")]),
    "figures": text_pdf_with_figures([(PAGE_TEXT, FIG_TEXT), (PAGE_TEXT, None)]),
    "garbage": b"not a pdf",
}

EXTRACTORS = {  # (port kwargs, reference kwargs)
    "default": ({}, {}),
    "strict": (dict(accept_score=0.99, use_cache=False), dict(accept_score=0.99, use_cache=False)),
    "ocr": (dict(ocr=ocr.toy_bitmap_ocr, ocr_accept_score=0.1),
            dict(ocr=jocr.toy_bitmap_ocr, ocr_accept_score=0.1)),
    "ocr_competes": (dict(ocr=ocr.toy_bitmap_ocr, ocr_accept_score=2.0),
                     dict(ocr=jocr.toy_bitmap_ocr, ocr_accept_score=2.0)),
}


def result_dict(res) -> dict:
    d = res.to_dict()
    d["metadata"] = {k: v for k, v in d["metadata"].items() if k not in TIMING_FIELDS}
    return d


@pytest.mark.parametrize("which", list(EXTRACTORS))
def test_extraction_results_equal_the_reference(which):
    ours_kw, theirs_kw = EXTRACTORS[which]
    ours, theirs = ext.PDFExtractor(**ours_kw), jext.PDFExtractor(**theirs_kw)
    for name, buf in PDFS.items():
        a, b = ours.extract_bytes(buf), theirs.extract_bytes(buf)
        assert result_dict(a) == result_dict(b), name
        assert set(a.metadata) == set(b.metadata), name


@pytest.mark.parametrize("name", [n for n in PDFS if n != "garbage"])
def test_pages_spans_tables_and_quality_equal_the_reference(name):
    buf = PDFS[name]
    doc, jdoc = ext.open_pdf(buf), jext.open_pdf(buf)
    pages = ext.extract_text(doc)
    assert pages == jext.extract_text(jdoc)
    assert extractor._strategy_simple(doc) == jextractor._strategy_simple(jdoc)
    page_spans, jpage_spans = [], []
    for page, jpage in zip(doc.pages(), jdoc.pages()):
        assert ext.extract_page_text(doc, page) == jext.extract_page_text(jdoc, jpage)
        spans, jspans = [], []
        contents, jcontents = doc.resolve(page.get("Contents")), jdoc.resolve(jpage.get("Contents"))
        if hasattr(contents, "data"):
            pdftext.ContentInterpreter(doc, doc.resolve(page.get("Resources")) or {},
                                       spans).run(contents.data())
            jpdftext.ContentInterpreter(jdoc, jdoc.resolve(jpage.get("Resources")) or {},
                                        jspans).run(jcontents.data())
        assert [vars(s) for s in spans] == [vars(s) for s in jspans]
        assert pdftext.spans_to_text(spans) == jpdftext.spans_to_text(jspans)
        assert [vars(t) for t in tables.detect_tables(spans)] == \
            [vars(t) for t in jtables.detect_tables(jspans)]
        assert tables.detect_footnotes(spans) == jtables.detect_footnotes(jspans)
        page_spans.append(spans)
        jpage_spans.append(jspans)
    assert vars(tables.analyze_layout(page_spans)) == vars(jtables.analyze_layout(jpage_spans))
    assert ext.extract_tables_bytes(buf) == jext.extract_tables_bytes(buf)
    text = "\n\n".join(pages)
    assert vars(ext.score_text(text, num_pages=len(pages))) == \
        vars(jext.score_text(text, num_pages=len(pages)))
    assert vars(ext.validate_extraction(pages)) == vars(jext.validate_extraction(pages))
    assert vars(ext.improve_pages(pages)) == vars(jext.improve_pages(pages))
    assert ext.improve_extraction(text, len(pages)) == jext.improve_extraction(text, len(pages))


def test_rtl_and_cmap_helpers_equal_the_reference():
    for line in ("A plain english line, nothing to do.", "با", "كتاب intro: (x) [y]",
                 "עברית 123 text"):
        for mark in (False, True):
            assert pdftext.reorder_rtl(line, mark=mark) == jpdftext.reorder_rtl(line, mark=mark)
    cmap = (b"/CIDInit /ProcSet findresource begin\n"
            b"beginbfchar\n<0041> <0061>\n<0042> <03B1>\nendbfchar\n"
            b"beginbfrange\n<0050> <0052> <0070>\n<0060> <0061> [<2211> <222B>]\nendbfrange\n"
            b"end")
    assert pdftext.parse_tounicode_cmap(cmap) == jpdftext.parse_tounicode_cmap(cmap)


def _outcome(module, buf: bytes):
    """(error class name, None) or (None, pages) for open + extract."""
    try:
        return None, module.extract_text(module.open_pdf(buf))
    except Exception as exc:  # the class is what is compared
        return type(exc).__name__, None


def _mutations(seed: int, trials: int, lo: int, hi: int, pdf: bytes):
    rng = random.Random(seed)
    for _ in range(trials):
        mutated = bytearray(pdf)
        for _ in range(rng.randint(lo, hi)):
            mutated[rng.randrange(len(mutated))] = rng.randrange(256)
        yield bytes(mutated)


def test_mutated_pdfs_fail_or_extract_alike():
    """Seeded byte mutations, truncations and garbage, as the reference's
    fuzz tests make them: the same error class or the same pages."""
    pdf = simple_text_pdf(["Corruption fuzzing body text."] * 2)
    bufs = list(_mutations(42, 30, 1, 20, pdf))
    base = simple_text_pdf(["Some stable text content for truncation fuzzing."])
    bufs += [base[: int(len(base) * f)] for f in (0.1, 0.3, 0.5, 0.7, 0.9, 0.99)]
    rng = random.Random(7)
    bufs += [b"", b"%PDF-1.5\n", b"%PDF-1.5\n" + bytes(rng.randrange(256) for _ in range(5000)),
             b"%PDF-" + b"\xff" * 100]
    outcomes = [(_outcome(ext, b), _outcome(jext, b)) for b in bufs]
    assert all(a == b for a, b in outcomes)
    assert any(a[0] for a, _ in outcomes) and any(a[1] for a, _ in outcomes)  # both kinds seen
    ours, theirs = ext.PDFExtractor(), jext.PDFExtractor()
    for buf in _mutations(3, 10, 5, 60, simple_text_pdf(["Extractor level fuzz body."])):
        assert result_dict(ours.extract_bytes(buf)) == result_dict(theirs.extract_bytes(buf))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_extraction_cache_is_shared(tmp_path, writer):
    """One package writes the JSON sidecar; the other finds it under the
    same key and returns it (shown by editing the cached text)."""
    pdf = tmp_path / "paper.pdf"
    pdf.write_bytes(simple_text_pdf(_random_pages(1, 3)))
    ours = ext.PDFExtractor(cache_dir=tmp_path / "cache")
    theirs = jext.PDFExtractor(cache_dir=tmp_path / "cache")
    first, second = (ours, theirs) if writer == "port" else (theirs, ours)
    assert ours._cache_path(pdf) == theirs._cache_path(pdf)
    res = first.extract(pdf)
    assert res.success
    cpath = ours._cache_path(pdf)
    cached = json.loads(cpath.read_text())
    assert cached == res.to_dict()
    cached["text"] = "edited in the cache"
    cpath.write_text(json.dumps(cached))
    again = second.extract(pdf)
    assert again.text == "edited in the cache" and again.pages == res.pages

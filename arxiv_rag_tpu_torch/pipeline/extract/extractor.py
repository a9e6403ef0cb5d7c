"""PDFExtractor: strategy cascade + quality competition + caching.

The port's own copy of ``arxiv_rag_tpu/pipeline/extract/extractor.py``.

The reference runs PyMuPDF → pdfplumber → pypdf on *every* paper and
keeps the best score (``pdf_extractor.py:338-382`` — it deliberately
never early-exits). This build keeps the quality-competition objective
but short-circuits at ``accept_score`` (SURVEY §7: "drop the
try-everything-always loop in favor of score-threshold early exit").

Strategies here:
  1. ``native``    — the in-repo interpreter (pdftext.py), position-aware;
  2. ``simple``    — same parser, but no layout pass (raw span order);
     catches documents where the layout heuristics hurt;
  3. ``external``  — optional fitz/pdfplumber/pypdf if present in the
     image (gated import; absent here, kept for portability);
  4. OCR via a pluggable hook (see extract/ocr.py for the protocol):
     OCR-first for scanned PDFs (accept at ``ocr_accept_score``,
     reference ``pdf_extractor.py:318-332``) and OCR-rescue when the
     best text strategy scores below ``ocr_rescue_score`` (:399-414).
     Without a hook (no tesseract in this image), scanned PDFs are
     flagged ``pdf_type='scanned'`` and reported as failed with a
     distinct error, never silently empty.

Cache: JSON sidecar keyed by (path, mtime, size) like
``pdf_extractor.py:194-242``.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from arxiv_rag_tpu_torch.logging_utils import get_logger

from . import pdfcore, pdftext
from .quality import QualityReport, score_text, validate_extraction

log = get_logger("extract")


@dataclass
class ExtractionResult:
    text: str
    pages: list[str]
    method_used: str
    quality_score: float
    pdf_type: str  # text | scanned | hybrid | unknown
    success: bool
    metadata: dict = field(default_factory=dict)
    error: str | None = None

    def to_dict(self) -> dict:
        return {
            "text": self.text,
            "pages": self.pages,
            "method_used": self.method_used,
            "quality_score": self.quality_score,
            "pdf_type": self.pdf_type,
            "success": self.success,
            "metadata": self.metadata,
            "error": self.error,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ExtractionResult":
        return cls(
            text=d.get("text", ""),
            pages=list(d.get("pages", [])),
            method_used=d.get("method_used", "cache"),
            quality_score=float(d.get("quality_score", 0.0)),
            pdf_type=d.get("pdf_type", "unknown"),
            success=bool(d.get("success", False)),
            metadata=dict(d.get("metadata", {})),
            error=d.get("error"),
        )


def _strategy_native(doc: pdfcore.Document) -> list[str]:
    return pdftext.extract_text(doc)


def _strategy_simple(doc: pdfcore.Document) -> list[str]:
    """No layout reconstruction: spans in emission order."""
    pages = []
    for page in doc.pages():
        contents = doc.resolve(page.get("Contents"))
        datas: list[bytes] = []
        if isinstance(contents, pdfcore.Stream):
            datas.append(contents.data())
        elif isinstance(contents, list):
            for c in contents:
                c = doc.resolve(c)
                if isinstance(c, pdfcore.Stream):
                    datas.append(c.data())
        spans: list[pdftext.Span] = []
        interp = pdftext.ContentInterpreter(doc, doc.resolve(page.get("Resources")) or {}, spans)
        if datas:
            interp.run(b"\n".join(datas))
        parts: list[str] = []
        last_y = None
        for s in spans:
            if last_y is not None and abs(s.y - last_y) > max(2.0, s.size * 0.4):
                parts.append("\n")
            elif parts and not parts[-1].endswith((" ", "\n")):
                parts.append(" ")
            parts.append(s.text)
            last_y = s.y
        pages.append("".join(parts).strip())
    return pages


def extract_tables_bytes(buf: bytes, max_pages: int | None = None) -> list[dict]:
    """Geometric table extraction (tables.py) over a whole document.
    Returns JSON-ready dicts (reference table path:
    ``pdf_extractor.py:912-1578`` via pdfplumber heuristics)."""
    from .tables import detect_tables

    doc = pdfcore.open_pdf(buf)
    out: list[dict] = []
    for pageno, page in enumerate(doc.pages()[:max_pages], start=1):
        contents = doc.resolve(page.get("Contents"))
        datas: list[bytes] = []
        if isinstance(contents, pdfcore.Stream):
            datas.append(contents.data())
        elif isinstance(contents, list):
            for c in contents:
                c = doc.resolve(c)
                if isinstance(c, pdfcore.Stream):
                    datas.append(c.data())
        if not datas:
            continue
        spans: list[pdftext.Span] = []
        interp = pdftext.ContentInterpreter(doc, doc.resolve(page.get("Resources")) or {}, spans)
        try:
            interp.run(b"\n".join(datas))
        except pdfcore.PDFError:
            continue
        for t in detect_tables(spans, page=pageno):
            out.append({"page": t.page, "n_cols": t.n_cols, "rows": t.rows})
    return out


def _external_strategies() -> list[tuple[str, Callable[[bytes], list[str]]]]:
    """Optional third-party extractors, if the image happens to have them."""
    out: list[tuple[str, Callable[[bytes], list[str]]]] = []
    try:  # pragma: no cover - not present in this image
        import fitz  # type: ignore

        def _fitz(buf: bytes) -> list[str]:
            with fitz.open(stream=buf, filetype="pdf") as d:
                return [p.get_text() for p in d]

        out.append(("pymupdf", _fitz))
    except ImportError:
        pass
    try:  # pragma: no cover
        import pypdf  # type: ignore
        import io

        def _pypdf(buf: bytes) -> list[str]:
            r = pypdf.PdfReader(io.BytesIO(buf))
            return [p.extract_text() or "" for p in r.pages]

        out.append(("pypdf", _pypdf))
    except ImportError:
        pass
    return out


class PDFExtractor:
    """Quality-competition extractor with sidecar caching.

    API parity with the reference facade (``pdf_extractor.py:244-439``):
    ``extract(path) -> ExtractionResult`` with the same field names.
    """

    def __init__(
        self,
        cache_dir: str | Path | None = None,
        accept_score: float = 0.80,
        min_score: float = 0.25,
        use_cache: bool = True,
        ocr: Callable[..., str] | None = None,
        ocr_accept_score: float = 0.6,
        ocr_rescue_score: float = 0.45,
        figure_ocr: bool = True,
    ) -> None:
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self.accept_score = accept_score
        self.min_score = min_score
        self.use_cache = use_cache and cache_dir is not None
        # ocr(data, *, width, height, bits_per_component, colorspace) -> str
        # (extract/ocr.py documents the protocol + a tesseract adapter)
        self.ocr = ocr
        self.ocr_accept_score = ocr_accept_score
        self.ocr_rescue_score = ocr_rescue_score
        # figure OCR: recover text inside images embedded in born-digital
        # pages and merge it next to the figure's caption (reference
        # ``pdf_extractor.py:5221-5506``); needs the same hook
        self.figure_ocr = figure_ocr
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    # -- cache -------------------------------------------------------------

    def _cache_path(self, path: Path) -> Path | None:
        if not self.use_cache or self.cache_dir is None:
            return None
        try:
            st = path.stat()
            key = f"{path.resolve()}|{st.st_mtime_ns}|{st.st_size}"
        except OSError:
            return None
        h = hashlib.sha1(key.encode()).hexdigest()[:24]
        return self.cache_dir / f"{h}.json"

    # -- type detection ----------------------------------------------------

    @staticmethod
    def detect_pdf_type(doc: pdfcore.Document, sample_pages: int = 3) -> str:
        """text | scanned | hybrid by sampling text yield of early pages
        (reference: ``pdf_extractor.py:5875-5930``)."""
        pages = doc.pages()[:sample_pages]
        if not pages:
            return "unknown"
        yields = []
        for p in pages:
            try:
                txt = pdftext.extract_page_text(doc, p)
            except Exception:
                txt = ""
            yields.append(len(txt.strip()))
        texty = sum(1 for y in yields if y > 100)
        if texty == 0:
            return "scanned"
        if texty < len(yields):
            return "hybrid"
        return "text"

    # -- main --------------------------------------------------------------

    def extract(self, path: str | Path) -> ExtractionResult:
        path = Path(path)
        cpath = self._cache_path(path)
        if cpath is not None and cpath.exists():
            try:
                return ExtractionResult.from_dict(json.loads(cpath.read_text()))
            except (json.JSONDecodeError, OSError):
                pass
        result = self.extract_bytes(path.read_bytes())
        if cpath is not None and result.success:
            try:
                cpath.write_text(json.dumps(result.to_dict()))
            except OSError:
                pass
        return result

    def extract_bytes(self, buf: bytes) -> ExtractionResult:
        t0 = time.perf_counter()
        try:
            doc = pdfcore.open_pdf(buf)
        except pdfcore.PDFEncryptedError:
            return ExtractionResult("", [], "none", 0.0, "unknown", False, error="encrypted")
        except pdfcore.PDFError as exc:
            return ExtractionResult("", [], "none", 0.0, "unknown", False, error=f"parse: {exc}")

        try:
            pdf_type = self.detect_pdf_type(doc)
            n_pages = len(doc.pages())
        except pdfcore.PDFError as exc:
            return ExtractionResult("", [], "none", 0.0, "unknown", False,
                                    error=f"structure: {exc}")
        best: tuple[float, str, list[str], QualityReport] | None = None
        ocr_ran = False
        if pdf_type == "scanned":
            if self.ocr is None:
                return ExtractionResult(
                    "", [], "none", 0.0, "scanned", False,
                    metadata={"num_pages": n_pages},
                    error="scanned PDF; no OCR backend in this environment",
                )
            # OCR-first for scanned documents (pdf_extractor.py:318-332):
            # accept immediately at ocr_accept_score, else let the text
            # strategies compete (they rarely beat OCR on a scan)
            ocr_cand = self._try_ocr(doc, n_pages)
            ocr_ran = True
            if ocr_cand is not None:
                best = ocr_cand
                if best[0] >= self.ocr_accept_score:
                    return self._finalize(best, pdf_type, t0)

        strategies: list[tuple[str, Callable[[], list[str]]]] = [
            ("native", lambda: _strategy_native(doc)),
            ("simple", lambda: _strategy_simple(doc)),
        ]
        for name, fn in _external_strategies():
            strategies.append((name, lambda fn=fn: fn(buf)))

        candidates: dict[str, list[str]] = {}
        for name, fn in strategies:
            try:
                pages = fn()
            except Exception as exc:
                log.debug("strategy %s failed: %s", name, exc)
                continue
            candidates[name] = pages
            text = "\n\n".join(pages)
            rep = score_text(text, num_pages=max(1, len(pages)))
            if best is None or rep.score > best[0]:
                best = (rep.score, name, pages, rep)
            if rep.score >= self.accept_score:
                break  # early exit — the deliberate departure from :352-372

        # per-page strategy mixing (reference ``pdf_extractor.py:839-910``
        # extracts each page through a strategy cascade and can mix
        # strategies within one document): when no whole-document
        # strategy reached accept_score, re-score page-wise and take
        # each page from whichever strategy extracted it best — one
        # malformed page no longer drags the whole document toward
        # OCR-rescue (VERDICT r3 missing #3).
        if best is not None and best[0] < self.accept_score and len(candidates) >= 2:
            mixed = self._merge_per_page(candidates)
            if mixed is not None and mixed[0] > best[0]:
                best = mixed

        # OCR-rescue: a hook is available and the best text strategy is
        # still poor (pdf_extractor.py:399-414's low-quality redo)
        # (skip if OCR already ran for this document — re-sweeping every
        # page image after a failed OCR-first pass doubles the most
        # expensive step for identical inputs)
        if (
            self.ocr is not None
            and not ocr_ran
            and (best is None or best[0] < self.ocr_rescue_score)
            and (best is None or best[1] != "ocr")
        ):
            ocr_ran = True
            ocr_cand = self._try_ocr(doc, n_pages)
            if ocr_cand is not None and (best is None or ocr_cand[0] > best[0]):
                best = ocr_cand

        if best is None:
            return ExtractionResult(
                "", [], "none", 0.0, pdf_type, False,
                metadata={"num_pages": n_pages}, error="all strategies failed",
            )

        # figure OCR: text pages can carry image XObjects whose content
        # (plot labels, diagram text) the text strategies can't see —
        # route them through the same OCR hook and merge next to the
        # figure captions (reference ``pdf_extractor.py:5221-5506``;
        # round-2 gap: images on text pages never reached the hook)
        extra_meta: dict = {}
        if (
            self.ocr is not None
            and self.figure_ocr
            and best[1] != "ocr"
            and pdf_type in ("text", "hybrid")
        ):
            best, fig_meta = self._merge_figure_ocr(doc, best)
            if fig_meta:
                extra_meta["figure_ocr"] = fig_meta

        return self._finalize(best, pdf_type, t0, extra_meta)

    def _merge_per_page(
        self, candidates: dict[str, list[str]]
    ) -> tuple[float, str, list[str], QualityReport] | None:
        """Best-per-page merge across strategies. Returns None when no
        actual mixing happened (every page chose the same strategy —
        the whole-document competition already covered that)."""
        n = max(len(p) for p in candidates.values())
        merged: list[str] = []
        sources: list[str] = []
        for i in range(n):
            # empty candidates don't compete: scoring '' as 0.0 would
            # beat real text that legitimately scores 0.0 (iteration
            # order) and attribute blank pages to a strategy, dropping
            # pages and fabricating 'mixed:' labels
            page_best: tuple[str, float, str | None] = ("", -1.0, None)
            for name, pages in candidates.items():
                pg = pages[i] if i < len(pages) else ""
                if not pg:
                    continue
                s = score_text(pg, num_pages=1).score
                if s > page_best[1]:
                    page_best = (pg, s, name)
            merged.append(page_best[0])
            if page_best[2] is not None:
                sources.append(page_best[2])
        if len(set(sources)) <= 1:
            return None
        rep = score_text("\n\n".join(merged), num_pages=max(1, n))
        name = "mixed:" + "+".join(sorted(set(sources)))
        return (rep.score, name, merged, rep)

    # caption anchors, matching crossref.py's "Figure N" taxonomy
    _CAPTION_RE = None  # compiled lazily below (module import order)

    def _merge_figure_ocr(
        self, doc: pdfcore.Document, best: tuple[float, str, list[str], QualityReport]
    ) -> tuple[tuple[float, str, list[str], QualityReport], dict | None]:
        """OCR image XObjects on text pages; append recovered text to the
        page, labeled with the page's Figure captions when they pair up
        1:1 in order. The text strategies' quality score is kept — figure
        text is additive evidence, and re-scoring would let noisy plot
        labels depress an otherwise clean extraction."""
        import re

        if PDFExtractor._CAPTION_RE is None:
            PDFExtractor._CAPTION_RE = re.compile(
                r"\b(?:Figure|Fig\.)\s*(\d+)", re.IGNORECASE
            )
        score, method, pages, rep = best
        pages = list(pages)
        n_images = n_recovered = 0
        figures: list[dict] = []
        try:
            for i, page in enumerate(doc.pages()):
                if i >= len(pages):
                    break
                recovered: list[str] = []
                for img in self.page_images(doc, page):
                    n_images += 1
                    d = img.dict
                    try:
                        data = img.data()
                    except pdfcore.PDFError:
                        continue
                    try:
                        txt = self.ocr(
                            data,
                            width=int(doc.resolve(d.get("Width", 0))),
                            height=int(doc.resolve(d.get("Height", 0))),
                            bits_per_component=int(
                                doc.resolve(d.get("BitsPerComponent", 8))
                            ),
                            colorspace=str(doc.resolve(d.get("ColorSpace", ""))),
                        )
                    except Exception as exc:  # noqa: BLE001 — best-effort
                        log.debug("figure ocr failed on page %d: %s", i + 1, exc)
                        continue
                    if txt and txt.strip():
                        n_recovered += 1
                        recovered.append(txt.strip())
                if not recovered:
                    continue
                captions = PDFExtractor._CAPTION_RE.findall(pages[i])
                blocks = []
                for j, txt in enumerate(recovered):
                    # pair image j with caption j only when the page's
                    # figure count matches its image count — otherwise
                    # the pairing is a guess; label by page instead
                    if len(captions) == len(recovered):
                        label = f"Figure {captions[j]}"
                    else:
                        label = f"figure (page {i + 1})"
                    blocks.append(f"[{label}] {txt}")
                    figures.append(
                        {
                            "page": i + 1,
                            "caption": (
                                f"Figure {captions[j]}"
                                if len(captions) == len(recovered)
                                else None
                            ),
                            "chars": len(txt),
                        }
                    )
                joiner = "\n\n" if pages[i] else ""
                pages[i] = pages[i] + joiner + "\n\n".join(blocks)
        except Exception as exc:  # noqa: BLE001 — never sink the extraction
            log.warning("figure ocr pass failed: %s", exc)
            return best, None
        if not n_recovered:
            return best, ({"images": n_images, "recovered": 0} if n_images else None)
        meta = {"images": n_images, "recovered": n_recovered, "figures": figures}
        return (score, method + "+figure_ocr", pages, rep), meta

    def _finalize(
        self,
        best: tuple[float, str, list[str], QualityReport],
        pdf_type: str,
        t0: float,
        extra_meta: dict | None = None,
    ) -> ExtractionResult:
        score, method, pages, rep = best
        validation = validate_extraction(pages)
        meta = {
            "num_pages": len(pages),
            "chars_per_page": rep.chars_per_page,
            "word_ratio": rep.word_ratio,
            "garbage_ratio": rep.garbage_ratio,
            "validation": validation.issues,
            "extract_seconds": round(time.perf_counter() - t0, 4),
        }
        if extra_meta:
            meta.update(extra_meta)
        text = "\n\n".join(pages)
        success = score >= self.min_score and bool(text.strip())
        return ExtractionResult(
            text=text,
            pages=pages,
            method_used=method,
            quality_score=round(score, 4),
            pdf_type=pdf_type,
            success=success,
            metadata=meta,
            error=None if success else f"quality {score:.2f} below min {self.min_score}",
        )

    # -- OCR ----------------------------------------------------------------

    @staticmethod
    def page_images(doc: pdfcore.Document, page: dict) -> list[pdfcore.Stream]:
        """Image XObjects reachable from a page's resources."""
        res = doc.resolve(page.get("Resources")) or {}
        xobjects = doc.resolve(res.get("XObject")) or {}
        out: list[pdfcore.Stream] = []
        for ref in xobjects.values():
            obj = doc.resolve(ref)
            if (
                isinstance(obj, pdfcore.Stream)
                and str(doc.resolve(obj.dict.get("Subtype"))) == "Image"
            ):
                out.append(obj)
        return out

    def _try_ocr(
        self, doc: pdfcore.Document, n_pages: int
    ) -> tuple[float, str, list[str], QualityReport] | None:
        """Run the OCR hook over every page's images; None on failure."""
        try:
            pages_text: list[str] = []
            for page in doc.pages():
                parts: list[str] = []
                for img in self.page_images(doc, page):
                    d = img.dict
                    try:
                        data = img.data()
                    except pdfcore.PDFError:
                        continue
                    txt = self.ocr(
                        data,
                        width=int(doc.resolve(d.get("Width", 0))),
                        height=int(doc.resolve(d.get("Height", 0))),
                        bits_per_component=int(doc.resolve(d.get("BitsPerComponent", 8))),
                        colorspace=str(doc.resolve(d.get("ColorSpace", ""))),
                    )
                    if txt and txt.strip():
                        parts.append(txt.strip())
                pages_text.append("\n".join(parts))
        except Exception as exc:  # noqa: BLE001 — OCR is best-effort
            log.warning("ocr hook failed: %s", exc)
            return None
        if not any(p.strip() for p in pages_text):
            return None
        rep = score_text("\n\n".join(pages_text), num_pages=max(1, n_pages))
        return (rep.score, "ocr", pages_text, rep)

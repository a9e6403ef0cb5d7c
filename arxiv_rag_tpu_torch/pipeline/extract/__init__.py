"""PDF extraction stage: in-repo PDF parser + quality competition.

The port's own copy of ``arxiv_rag_tpu/pipeline/extract/__init__.py``.

Replaces the reference's 9k-line multi-library extractor
(``2-extraction/pdf_extractor.py``) with a self-contained reader
(no fitz/pdfplumber/pypdf exist in this image), a strategy cascade
with score-threshold early exit, and an improvement pass.
"""

from .extractor import ExtractionResult, PDFExtractor, extract_tables_bytes
from .improve import ImproveResult, improve_extraction, improve_pages
from .pdfcore import Document, PDFEncryptedError, PDFError, open_pdf
from .pdftext import extract_page_text, extract_text
from .quality import QualityReport, ValidationResult, score_text, validate_extraction

__all__ = [
    "Document",
    "ExtractionResult",
    "extract_tables_bytes",
    "ImproveResult",
    "PDFEncryptedError",
    "PDFError",
    "PDFExtractor",
    "QualityReport",
    "ValidationResult",
    "extract_page_text",
    "extract_text",
    "improve_extraction",
    "improve_pages",
    "open_pdf",
    "score_text",
    "validate_extraction",
]

"""OCR interface for scanned PDFs.

The port's own copy of ``arxiv_rag_tpu/pipeline/extract/ocr.py``.

The reference OCRs scanned documents first and rescues low-quality
extractions with OCR (``2-extraction/pdf_extractor.py:318-332,399-414``,
engine at ``:5727-5875``) through pytesseract. This image has no
tesseract, so the framework ships the *interface*: ``PDFExtractor``
takes an ``ocr`` callable and routes page images through it; without
one, scanned PDFs fail loudly with a distinct error (never silent
empties).

Protocol
--------
``ocr(data, *, width, height, bits_per_component, colorspace) -> str``

``data`` is the decoded image stream of one page-level image XObject
(packed rows for raw bitmaps; original bytes for DCT/JPX-compressed
images, which pdfcore passes through). A tesseract adapter is a few
lines::

    def tesseract_ocr(data, *, width, height, bits_per_component, colorspace):
        from PIL import Image
        import pytesseract
        mode = "1" if bits_per_component == 1 else "L"
        img = Image.frombytes(mode, (width, height), data)
        return pytesseract.image_to_string(img)

``toy_bitmap_ocr`` below decodes the machine-glyph bitmap format the
test corpus uses (tests/pdfgen.py ``scanned_pdf``): a 1-bit DeviceGray
image of 8×8 cells where all eight rows of a cell carry the character's
code point as a bit pattern. It exists so the OCR routing is testable
end to end in an image without tesseract.
"""

from __future__ import annotations

import importlib
from typing import Callable


def load_ocr_plugin(spec: str) -> Callable[..., str] | None:
    """Resolve a ``module.path:callable`` OCR plugin spec ('' -> None).

    Raises ImportError/AttributeError loudly on a bad spec — a typo'd
    plugin must not silently downgrade to no-OCR.
    """
    if not spec:
        return None
    mod, sep, attr = spec.partition(":")
    if not sep or not attr:
        raise ValueError(f"ocr_plugin must be 'module:callable', got {spec!r}")
    return getattr(importlib.import_module(mod), attr)


def toy_bitmap_ocr(
    data: bytes,
    *,
    width: int,
    height: int,
    bits_per_component: int = 1,
    colorspace: str = "DeviceGray",
) -> str:
    """Decode the synthetic machine-glyph bitmap (see module docstring)."""
    if bits_per_component != 1 or width % 8 or height % 8:
        return ""
    stride = (width + 7) // 8  # bytes per pixel row
    lines = []
    for cell_row in range(height // 8):
        row = data[cell_row * 8 * stride : cell_row * 8 * stride + stride]
        chars = [chr(b) for b in row if 32 <= b < 127]
        lines.append("".join(chars).rstrip())
    return "\n".join(lines).strip()

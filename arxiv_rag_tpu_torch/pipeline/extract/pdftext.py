"""PDF text extraction: content-stream interpretation → page text.

The port's own copy of ``arxiv_rag_tpu/pipeline/extract/pdftext.py``.

Replaces the reference's per-page strategy cascade over
fitz/pdfplumber/pypdf (``pdf_extractor.py:839-910``) with one
position-aware interpreter:

- text state machine (BT/ET, Tf/Td/TD/Tm/T*/TL/Tc/Tw/Tz, Tj/TJ/'/\"),
  full CTM tracking (cm, q/Q) so rotated/translated text lands at the
  right device coordinates;
- simple-font decoding via /Encoding (+ /Differences) and /ToUnicode
  CMaps (bfchar + bfrange), composite (Type0/Identity-H) 2-byte codes;
- XObject /Form recursion;
- reading order: spans are grouped into lines by baseline Y, lines
  sorted top→bottom; two-column layouts are detected by an x-histogram
  valley and emitted left column first (reference multi-column
  reconstruction: ``pdf_extractor.py:4271-4669``);
- word spacing inferred from glyph advance (font widths + Tc/Tw/TJ
  offsets), so no reliance on space glyphs being present.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any

from .pdfcore import Document, Lexer, Name, PDFError, Ref, Stream
from .encodings import STANDARD_ENCODING, WINANSI_ENCODING, MACROMAN_ENCODING, SYMBOL_MAP, GLYPH_LIST


@dataclass
class Span:
    """A run of decoded text at a device position."""

    text: str
    x: float
    y: float
    end_x: float
    size: float
    font: str = ""


# ---------------------------------------------------------------------------
# fonts
# ---------------------------------------------------------------------------


class Font:
    """Decoder from byte codes to unicode + advance widths."""

    def __init__(self, doc: Document, fdict: dict) -> None:
        self.doc = doc
        self.fdict = fdict
        self.subtype = doc.resolve(fdict.get("Subtype"))
        self.two_byte = False
        self.to_unicode: dict[int, str] = {}
        self.encoding_map: dict[int, str] = {}
        self.widths: dict[int, float] = {}
        self.default_width = 500.0
        self.name = str(doc.resolve(fdict.get("BaseFont")) or "")
        try:
            if self.subtype == "Type0":
                self._init_type0()
            else:
                self._init_simple()
        except PDFError:
            pass
        tu = doc.resolve(fdict.get("ToUnicode"))
        if isinstance(tu, Stream):
            try:
                self.to_unicode = parse_tounicode_cmap(tu.data())
            except Exception:
                pass

    def _init_simple(self) -> None:
        doc = self.doc
        base: dict[int, str]
        enc = doc.resolve(self.fdict.get("Encoding"))
        symbolic = "Symbol" in self.name or "Dingbat" in self.name
        if isinstance(enc, Name):
            base = _named_encoding(str(enc))
        elif symbolic:
            base = dict(SYMBOL_MAP)
        else:
            base = dict(STANDARD_ENCODING)
        if isinstance(enc, dict):
            base_name = doc.resolve(enc.get("BaseEncoding"))
            base = _named_encoding(str(base_name)) if base_name else dict(base)
            diffs = doc.resolve(enc.get("Differences")) or []
            code = 0
            for item in diffs:
                item = doc.resolve(item)
                if isinstance(item, (int, float)):
                    code = int(item)
                elif isinstance(item, Name):
                    base[code] = glyph_to_unicode(str(item))
                    code += 1
        self.encoding_map = base
        fc = doc.resolve(self.fdict.get("FirstChar"))
        widths = doc.resolve(self.fdict.get("Widths"))
        if isinstance(widths, list) and isinstance(fc, (int, float)):
            for i, w in enumerate(widths):
                w = doc.resolve(w)
                if isinstance(w, (int, float)):
                    self.widths[int(fc) + i] = float(w)

    def _init_type0(self) -> None:
        doc = self.doc
        self.two_byte = True  # Identity-H/V and practically all arXiv CID fonts
        desc = doc.resolve(self.fdict.get("DescendantFonts"))
        if isinstance(desc, list) and desc:
            d0 = doc.resolve(desc[0])
            if isinstance(d0, dict):
                dw = doc.resolve(d0.get("DW"))
                if isinstance(dw, (int, float)):
                    self.default_width = float(dw)
                else:
                    self.default_width = 1000.0
                w = doc.resolve(d0.get("W"))
                if isinstance(w, list):
                    self._parse_cid_widths([doc.resolve(x) for x in w])

    def _parse_cid_widths(self, w: list) -> None:
        i = 0
        while i < len(w):
            first = w[i]
            if i + 1 < len(w) and isinstance(w[i + 1], list):
                arr = [self.doc.resolve(x) for x in w[i + 1]]
                for j, width in enumerate(arr):
                    if isinstance(width, (int, float)):
                        self.widths[int(first) + j] = float(width)
                i += 2
            elif i + 2 < len(w):
                last, width = w[i + 1], w[i + 2]
                if all(isinstance(x, (int, float)) for x in (first, last, width)):
                    for c in range(int(first), int(last) + 1):
                        self.widths[c] = float(width)
                i += 3
            else:
                break

    def iter_codes(self, raw: bytes):
        """Yield (code, is_space_candidate) glyph codes from a string."""
        if self.two_byte:
            for i in range(0, len(raw) - 1, 2):
                yield (raw[i] << 8) | raw[i + 1]
        else:
            yield from raw

    def code_to_unicode(self, code: int) -> str:
        if code in self.to_unicode:
            return self.to_unicode[code]
        if code in self.encoding_map:
            return self.encoding_map[code]
        if not self.two_byte and 0x20 <= code < 0x7F:
            return chr(code)
        return ""

    def width(self, code: int) -> float:
        w = self.widths.get(code)
        if w is None:
            return self.default_width
        return w


def _named_encoding(name: str) -> dict[int, str]:
    if name == "WinAnsiEncoding":
        return dict(WINANSI_ENCODING)
    if name == "MacRomanEncoding":
        return dict(MACROMAN_ENCODING)
    return dict(STANDARD_ENCODING)


def glyph_to_unicode(glyph: str) -> str:
    if glyph in GLYPH_LIST:
        return GLYPH_LIST[glyph]
    m = re.fullmatch(r"uni([0-9A-Fa-f]{4,6})", glyph)
    if m:
        try:
            return chr(int(m.group(1)[:6], 16))
        except ValueError:
            return ""
    m = re.fullmatch(r"u([0-9A-Fa-f]{4,6})", glyph)
    if m:
        try:
            return chr(int(m.group(1), 16))
        except ValueError:
            return ""
    if len(glyph) == 1:
        return glyph
    return ""


_CMAP_BFCHAR = re.compile(rb"beginbfchar(.*?)endbfchar", re.S)
_CMAP_BFRANGE = re.compile(rb"beginbfrange(.*?)endbfrange", re.S)
_HEX = re.compile(rb"<([0-9A-Fa-f]+)>")


def _hex_to_str(h: bytes) -> str:
    """UTF-16BE hex token → python str."""
    try:
        b = bytes.fromhex(h.decode("ascii"))
    except ValueError:
        return ""
    if len(b) % 2:
        b += b"\x00"
    try:
        return b.decode("utf-16-be", errors="ignore")
    except Exception:
        return ""


def parse_tounicode_cmap(data: bytes) -> dict[int, str]:
    out: dict[int, str] = {}
    for block in _CMAP_BFCHAR.finditer(data):
        toks = _HEX.findall(block.group(1))
        for i in range(0, len(toks) - 1, 2):
            src = int(toks[i], 16)
            out[src] = _hex_to_str(toks[i + 1])
    for block in _CMAP_BFRANGE.finditer(data):
        body = block.group(1)
        # two forms: <lo> <hi> <dst>  |  <lo> <hi> [<d1> <d2> ...]
        pos = 0
        pat = re.compile(rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*(\[(?:[^\]]*)\]|<[0-9A-Fa-f]+>)", re.S)
        for m in pat.finditer(body):
            lo, hi = int(m.group(1), 16), int(m.group(2), 16)
            dst = m.group(3)
            if dst.startswith(b"["):
                arr = _HEX.findall(dst)
                for i, d in enumerate(arr):
                    if lo + i <= hi:
                        out[lo + i] = _hex_to_str(d)
            else:
                base_hex = _HEX.match(dst).group(1)
                base_str = _hex_to_str(base_hex)
                if base_str:
                    base_cp = ord(base_str[-1])
                    prefix = base_str[:-1]
                    for i in range(hi - lo + 1):
                        out[lo + i] = prefix + chr(base_cp + i)
    return out


# ---------------------------------------------------------------------------
# content stream interpreter
# ---------------------------------------------------------------------------


def _matmul(a, b):
    """3x3 affine as 6-tuple (a,b,c,d,e,f): row-vector convention."""
    a0, a1, a2, a3, a4, a5 = a
    b0, b1, b2, b3, b4, b5 = b
    return (
        a0 * b0 + a1 * b2,
        a0 * b1 + a1 * b3,
        a2 * b0 + a3 * b2,
        a2 * b1 + a3 * b3,
        a4 * b0 + a5 * b2 + b4,
        a4 * b1 + a5 * b3 + b5,
    )


IDENTITY = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


class ContentInterpreter:
    def __init__(self, doc: Document, resources: dict, spans: list[Span], depth: int = 0) -> None:
        self.doc = doc
        self.resources = resources or {}
        self.spans = spans
        self.depth = depth
        self.fonts: dict[str, Font] = {}
        # graphics state
        self.ctm = IDENTITY
        self.stack: list[tuple] = []
        # text state
        self.tm = IDENTITY
        self.tlm = IDENTITY
        self.font: Font | None = None
        self.size = 0.0
        self.char_spacing = 0.0
        self.word_spacing = 0.0
        self.hscale = 1.0
        self.leading = 0.0
        self.rise = 0.0

    def _get_font(self, name: str) -> Font | None:
        if name in self.fonts:
            return self.fonts[name]
        fres = self.doc.resolve(self.resources.get("Font")) or {}
        fdict = self.doc.resolve(fres.get(name))
        font = Font(self.doc, fdict) if isinstance(fdict, dict) else None
        self.fonts[name] = font
        return font

    def run(self, data: bytes) -> None:
        lx = Lexer(data)
        stack: list[Any] = []
        n = len(data)
        while True:
            lx.skip_ws()
            if lx.pos >= n:
                break
            c = lx.peek_byte()
            if c in b"/(<[" or c == 0x2B or c == 0x2D or c == 0x2E or 0x30 <= c <= 0x39:
                try:
                    obj = lx.parse_object()
                except PDFError:
                    lx.pos += 1
                    continue
                if isinstance(obj, tuple):  # inline dict+stream marker — shouldn't happen here
                    continue
                stack.append(obj)
                continue
            # operator token
            start = lx.pos
            while lx.pos < n and data[lx.pos] not in b"\x00\t\n\x0c\r ()<>[]{}/%":
                lx.pos += 1
            op = data[start : lx.pos].decode("latin-1", "replace")
            if not op:
                lx.pos += 1
                continue
            try:
                self._op(op, stack, lx)
            except Exception:
                pass
            stack.clear()

    def _op(self, op: str, stack: list, lx: Lexer) -> None:
        if op == "BT":
            self.tm = self.tlm = IDENTITY
        elif op == "ET":
            pass
        elif op == "Tf" and len(stack) >= 2:
            self.font = self._get_font(str(stack[-2]))
            self.size = float(stack[-1])
        elif op == "Td" and len(stack) >= 2:
            self.tlm = _matmul((1, 0, 0, 1, float(stack[-2]), float(stack[-1])), self.tlm)
            self.tm = self.tlm
        elif op == "TD" and len(stack) >= 2:
            self.leading = -float(stack[-1])
            self.tlm = _matmul((1, 0, 0, 1, float(stack[-2]), float(stack[-1])), self.tlm)
            self.tm = self.tlm
        elif op == "Tm" and len(stack) >= 6:
            self.tlm = tuple(float(x) for x in stack[-6:])
            self.tm = self.tlm
        elif op == "T*":
            self.tlm = _matmul((1, 0, 0, 1, 0.0, -self.leading), self.tlm)
            self.tm = self.tlm
        elif op == "TL" and stack:
            self.leading = float(stack[-1])
        elif op == "Tc" and stack:
            self.char_spacing = float(stack[-1])
        elif op == "Tw" and stack:
            self.word_spacing = float(stack[-1])
        elif op == "Tz" and stack:
            self.hscale = float(stack[-1]) / 100.0
        elif op == "Ts" and stack:
            self.rise = float(stack[-1])
        elif op == "Tj" and stack:
            self._show(stack[-1])
        elif op == "'" and stack:
            self.tlm = _matmul((1, 0, 0, 1, 0.0, -self.leading), self.tlm)
            self.tm = self.tlm
            self._show(stack[-1])
        elif op == '"' and len(stack) >= 3:
            self.word_spacing = float(stack[-3])
            self.char_spacing = float(stack[-2])
            self.tlm = _matmul((1, 0, 0, 1, 0.0, -self.leading), self.tlm)
            self.tm = self.tlm
            self._show(stack[-1])
        elif op == "TJ" and stack and isinstance(stack[-1], list):
            for item in stack[-1]:
                if isinstance(item, (bytes, bytearray)):
                    self._show(bytes(item))
                elif isinstance(item, (int, float)):
                    # negative = rightward shift in thousandths of em
                    shift = -float(item) / 1000.0 * self.size * self.hscale
                    if self.font and float(item) < -180:
                        self._append_space()
                    self.tm = _matmul((1, 0, 0, 1, shift, 0), self.tm)
        elif op == "cm" and len(stack) >= 6:
            self.ctm = _matmul(tuple(float(x) for x in stack[-6:]), self.ctm)
        elif op == "q":
            self.stack.append((self.ctm,))
        elif op == "Q":
            if self.stack:
                (self.ctm,) = self.stack.pop()
        elif op == "Do" and stack:
            self._do_xobject(str(stack[-1]))
        elif op == "BI":
            # inline image: skip to EI
            buf = lx.buf
            idx = buf.find(b"EI", lx.pos)
            lx.pos = len(buf) if idx == -1 else idx + 2

    def _append_space(self) -> None:
        if self.spans and self.spans[-1].text and not self.spans[-1].text.endswith(" "):
            self.spans[-1].text += " "

    def _show(self, raw) -> None:
        if not isinstance(raw, (bytes, bytearray)) or self.font is None:
            return
        font = self.font
        size = self.size
        trm = _matmul(self.tm, self.ctm)
        x0 = trm[4]
        y0 = trm[5]
        eff_size = size * (trm[0] ** 2 + trm[1] ** 2) ** 0.5 if (trm[0] or trm[1]) else size
        chars: list[str] = []
        advance = 0.0
        for code in font.iter_codes(bytes(raw)):
            u = font.code_to_unicode(code)
            w = font.width(code) / 1000.0 * size
            tx = (w + self.char_spacing + (self.word_spacing if (not font.two_byte and code == 32) else 0.0)) * self.hscale
            advance += tx
            chars.append(u if u else "")
        text = "".join(chars)
        # advance text matrix
        self.tm = _matmul((1, 0, 0, 1, advance, 0), self.tm)
        if not text:
            return
        end_trm = _matmul(self.tm, self.ctm)
        self.spans.append(
            Span(text=text, x=x0, y=y0, end_x=end_trm[4], size=abs(eff_size) or 1.0, font=font.name)
        )

    def _do_xobject(self, name: str) -> None:
        if self.depth > 8:
            return
        xres = self.doc.resolve(self.resources.get("XObject")) or {}
        xo = self.doc.resolve(xres.get(name))
        if not isinstance(xo, Stream):
            return
        if self.doc.resolve(xo.dict.get("Subtype")) != "Form":
            return
        sub = ContentInterpreter(
            self.doc,
            self.doc.resolve(xo.dict.get("Resources")) or self.resources,
            self.spans,
            self.depth + 1,
        )
        sub.ctm = self.ctm
        mtx = self.doc.resolve(xo.dict.get("Matrix"))
        if isinstance(mtx, list) and len(mtx) == 6:
            sub.ctm = _matmul(tuple(float(x) for x in mtx), sub.ctm)
        try:
            sub.run(xo.data())
        except PDFError:
            pass


# ---------------------------------------------------------------------------
# layout: spans → lines → columns → page text
# ---------------------------------------------------------------------------
# RTL / bidirectional text
# ---------------------------------------------------------------------------

# Strong right-to-left script blocks (reference set: pdf_extractor.py:
# 5006-5015, extended with presentation forms that real PDFs embed).
_RTL_RANGES = (
    (0x0590, 0x05FF),  # Hebrew
    (0x0600, 0x06FF),  # Arabic
    (0x0700, 0x074F),  # Syriac
    (0x0750, 0x077F),  # Arabic Supplement
    (0x0780, 0x07BF),  # Thaana
    (0x07C0, 0x07FF),  # NKo
    (0x0800, 0x083F),  # Samaritan
    (0x0840, 0x085F),  # Mandaic
    (0x08A0, 0x08FF),  # Arabic Extended-A
    (0xFB1D, 0xFB4F),  # Hebrew presentation forms
    (0xFB50, 0xFDFF),  # Arabic presentation forms A
    (0xFE70, 0xFEFF),  # Arabic presentation forms B
)

# Paired punctuation is mirrored when a visual-order run is reversed.
_MIRROR = str.maketrans("()[]{}<>", ")(][}{><")


def _is_rtl(ch: str) -> bool:
    cp = ord(ch)
    for lo, hi in _RTL_RANGES:
        if lo <= cp <= hi:
            return True
    return False


def reorder_rtl(line: str, mark: bool = False) -> str:
    """Re-emit visually-ordered RTL runs in logical order.

    The assembler sorts spans left→right — *visual* order. RTL scripts
    read right→left, so a maximal run of RTL characters (neutral
    characters between two RTL characters stay inside the run; strong
    Latin/digit characters break it) is reversed to recover logical
    order, with paired brackets mirrored. With ``mark=True`` each run is
    additionally wrapped in RLE…PDF directional controls, matching the
    reference's per-line marking (``pdf_extractor.py:4986-5220``; the
    reference only marks — it trusts its extractor's bidi pass, which a
    from-scratch x-sorted assembler must perform itself).
    """
    if not line or not any(_is_rtl(c) for c in line):
        return line
    n = len(line)
    out: list[str] = []
    i = 0
    while i < n:
        if not _is_rtl(line[i]):
            out.append(line[i])
            i += 1
            continue
        # maximal run: extend through neutrals only when another RTL
        # char follows before any strong LTR (ASCII alnum) char
        j = i + 1
        last_rtl = i
        while j < n:
            c = line[j]
            if _is_rtl(c):
                last_rtl = j
                j += 1
            elif c.isascii() and c.isalnum():
                break
            else:
                j += 1
        run = line[i : last_rtl + 1][::-1].translate(_MIRROR)
        if mark:
            run = "\u202b" + run + "\u202c"  # RLE ... PDF
        out.append(run)
        i = last_rtl + 1
    return "".join(out)


# ---------------------------------------------------------------------------


def _assemble_lines(spans: list[Span]) -> list[tuple[float, float, str]]:
    """Group spans into (y, x_start, text) lines by baseline."""
    lines: dict[float, list[Span]] = {}
    for s in spans:
        key = round(s.y / max(s.size * 0.45, 2.0))
        lines.setdefault(key, []).append(s)
    assembled: list[tuple[float, float, str]] = []
    for group in lines.values():
        group.sort(key=lambda s: s.x)
        parts: list[str] = []
        prev_end = None
        prev_size = group[0].size
        for s in group:
            if prev_end is not None:
                gap = s.x - prev_end
                if gap > max(0.18 * prev_size, 1.2):
                    parts.append(" ")
            parts.append(s.text)
            prev_end = max(s.end_x, s.x)
            prev_size = s.size
        text = reorder_rtl("".join(parts).strip())
        if text:
            assembled.append((group[0].y, group[0].x, text))
    assembled.sort(key=lambda l: (-l[0], l[1]))
    return assembled


def spans_to_text(spans: list[Span], page_width: float = 612.0) -> str:
    """Assemble reading-order text with REGION-based column handling.

    Real papers mix full-width regions (title, abstract, wide figures)
    with two-column body text on the same page. Baselines are scanned
    top→bottom; maximal runs of baselines where no span crosses the
    mid-page gutter AND both halves carry text form a columnar region,
    emitted left column first. Full-width baselines pass through in
    order (reference multi-column pass: ``pdf_extractor.py:4271-4669``).
    """
    if not spans:
        return ""
    spans = [s for s in spans if s.text.strip() or " " in s.text]
    if not spans:
        return ""

    mid = page_width / 2.0
    # group spans into baselines (top→bottom)
    groups: dict[float, list[Span]] = {}
    for s in spans:
        key = round(s.y / max(s.size * 0.45, 2.0))
        groups.setdefault(key, []).append(s)
    baselines = sorted(groups.values(), key=lambda g: -g[0].y)

    def crosses(g: list[Span]) -> bool:
        return any(
            s.x < mid * 0.8 and s.end_x > mid * 1.1 and len(s.text) > 4 for s in g
        )

    out_lines: list[str] = []

    def flush_region(region: list[list[Span]]) -> None:
        if not region:
            return
        flat = [s for g in region for s in g]
        left = [s for s in flat if s.x < mid * 0.9]
        right = [s for s in flat if s.x >= mid * 0.9]
        columnar = (
            len(region) >= 4
            and len(left) >= 2
            and len(right) >= 2
            and len(right) >= 0.2 * len(flat)
        )
        if columnar:
            out_lines.extend(l[2] for l in _assemble_lines(left))
            out_lines.extend(l[2] for l in _assemble_lines(right))
        else:
            out_lines.extend(l[2] for l in _assemble_lines(flat))

    region: list[list[Span]] = []
    for g in baselines:
        if crosses(g):
            flush_region(region)
            region = []
            out_lines.extend(l[2] for l in _assemble_lines(g))
        else:
            region.append(g)
    flush_region(region)
    return "\n".join(out_lines)


def extract_page_text(doc: Document, page: dict) -> str:
    contents = doc.resolve(page.get("Contents"))
    datas: list[bytes] = []
    if isinstance(contents, Stream):
        datas.append(contents.data())
    elif isinstance(contents, list):
        for c in contents:
            c = doc.resolve(c)
            if isinstance(c, Stream):
                datas.append(c.data())
    if not datas:
        return ""
    spans: list[Span] = []
    resources = doc.resolve(page.get("Resources")) or {}
    interp = ContentInterpreter(doc, resources, spans)
    interp.run(b"\n".join(datas))
    mb = doc.resolve(page.get("MediaBox")) or [0, 0, 612, 792]
    try:
        width = float(doc.resolve(mb[2])) - float(doc.resolve(mb[0]))
    except Exception:
        width = 612.0
    return spans_to_text(spans, width)


def extract_text(doc: Document) -> list[str]:
    """Per-page text for the whole document."""
    return [extract_page_text(doc, p) for p in doc.pages()]

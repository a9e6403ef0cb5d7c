"""Minimal PDF object model + document parser (pure Python, stdlib only).

The port's own copy of ``arxiv_rag_tpu/pipeline/extract/pdfcore.py``.

The reference outsources PDF parsing to MuPDF/pdfplumber/pypdf
(``pdf_extractor.py:17,28,34``); none of those exist in this image, so
the framework carries its own reader. Scope: everything needed for text
extraction from arXiv-style PDFs —

- object lexer: numbers, names, literal/hex strings, arrays, dicts,
  indirect references, streams;
- classic xref tables AND cross-reference streams (PDF 1.5+), with
  /Prev chains and startxref recovery by brute scan;
- object streams (/ObjStm) holding compressed objects;
- stream filters: FlateDecode (w/ PNG predictors), ASCIIHexDecode,
  ASCII85Decode, RunLengthDecode, LZWDecode;
- page-tree walk with attribute inheritance (Resources/MediaBox).

Rendering-only features (images, shading, encryption) are out of scope;
encrypted documents raise ``PDFEncryptedError``.
"""

from __future__ import annotations

import re
import zlib
from dataclasses import dataclass
from typing import Any


class PDFError(Exception):
    pass


class PDFEncryptedError(PDFError):
    pass


class Name(str):
    """A PDF name object (/Foo). Subclass of str for dict-key ergonomics."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover
        return f"/{str(self)}"


@dataclass(frozen=True)
class Ref:
    num: int
    gen: int


@dataclass
class Stream:
    dict: dict
    raw: bytes
    doc: "Document | None" = None

    def data(self) -> bytes:
        return decode_stream(self.dict, self.raw, self.doc)


WHITESPACE = b"\x00\t\n\x0c\r "
DELIMS = b"()<>[]{}/%"
_NUM_RE = re.compile(rb"[+-]?(?:\d+\.?\d*|\.\d+)")


class Lexer:
    """Tokenizer/parser over a bytes buffer."""

    def __init__(self, buf: bytes, pos: int = 0) -> None:
        self.buf = buf
        self.pos = pos

    # -- low level ---------------------------------------------------------

    def skip_ws(self) -> None:
        buf, n = self.buf, len(self.buf)
        pos = self.pos
        while pos < n:
            c = buf[pos]
            if c in WHITESPACE:
                pos += 1
            elif c == 0x25:  # '%' comment to EOL
                while pos < n and buf[pos] not in b"\r\n":
                    pos += 1
            else:
                break
        self.pos = pos

    def peek_byte(self) -> int:
        return self.buf[self.pos] if self.pos < len(self.buf) else -1

    def expect(self, token: bytes) -> None:
        self.skip_ws()
        if not self.buf.startswith(token, self.pos):
            raise PDFError(f"expected {token!r} at {self.pos}")
        self.pos += len(token)

    def try_keyword(self, kw: bytes) -> bool:
        self.skip_ws()
        end = self.pos + len(kw)
        if self.buf.startswith(kw, self.pos) and (
            end >= len(self.buf) or self.buf[end] in WHITESPACE or self.buf[end] in DELIMS
        ):
            self.pos = end
            return True
        return False

    # -- object parsing ----------------------------------------------------

    def parse_object(self) -> Any:
        self.skip_ws()
        if self.pos >= len(self.buf):
            raise PDFError("EOF while parsing object")
        c = self.buf[self.pos]
        if c == 0x2F:  # /
            return self._parse_name()
        if c == 0x28:  # (
            return self._parse_literal_string()
        if c == 0x3C:  # <
            if self.buf.startswith(b"<<", self.pos):
                return self._parse_dict_or_stream()
            return self._parse_hex_string()
        if c == 0x5B:  # [
            self.pos += 1
            arr = []
            while True:
                self.skip_ws()
                if self.peek_byte() == 0x5D:
                    self.pos += 1
                    return arr
                arr.append(self.parse_object())
        if self.try_keyword(b"true"):
            return True
        if self.try_keyword(b"false"):
            return False
        if self.try_keyword(b"null"):
            return None
        m = _NUM_RE.match(self.buf, self.pos)
        if m:
            # indirect reference lookahead: "N G R"
            save = self.pos
            self.pos = m.end()
            tok = m.group()
            if b"." not in tok:
                ws = self.pos
                self.skip_ws()
                m2 = _NUM_RE.match(self.buf, self.pos)
                if m2 and b"." not in m2.group():
                    self.pos = m2.end()
                    if self.try_keyword(b"R"):
                        return Ref(int(tok), int(m2.group()))
                self.pos = ws
                self.pos = m.end()
                return int(tok)
            return float(tok)
        raise PDFError(f"cannot parse object at {self.pos}: {self.buf[self.pos:self.pos+20]!r}")

    def _parse_name(self) -> Name:
        assert self.buf[self.pos] == 0x2F
        self.pos += 1
        out = bytearray()
        buf, n = self.buf, len(self.buf)
        while self.pos < n:
            c = buf[self.pos]
            if c in WHITESPACE or c in DELIMS:
                break
            if c == 0x23 and self.pos + 2 < n:  # #XX escape
                try:
                    out.append(int(buf[self.pos + 1 : self.pos + 3], 16))
                    self.pos += 3
                    continue
                except ValueError:
                    pass
            out.append(c)
            self.pos += 1
        return Name(out.decode("latin-1"))

    def _parse_literal_string(self) -> bytes:
        assert self.buf[self.pos] == 0x28
        self.pos += 1
        out = bytearray()
        depth = 1
        buf, n = self.buf, len(self.buf)
        while self.pos < n:
            c = buf[self.pos]
            self.pos += 1
            if c == 0x5C:  # backslash
                if self.pos >= n:
                    break
                e = buf[self.pos]
                self.pos += 1
                if e == 0x6E:
                    out.append(0x0A)
                elif e == 0x72:
                    out.append(0x0D)
                elif e == 0x74:
                    out.append(0x09)
                elif e == 0x62:
                    out.append(0x08)
                elif e == 0x66:
                    out.append(0x0C)
                elif e in b"()\\":
                    out.append(e)
                elif e in b"\r\n":  # line continuation
                    if e == 0x0D and self.pos < n and buf[self.pos] == 0x0A:
                        self.pos += 1
                elif 0x30 <= e <= 0x37:  # octal
                    oct_digits = [e - 0x30]
                    while len(oct_digits) < 3 and self.pos < n and 0x30 <= buf[self.pos] <= 0x37:
                        oct_digits.append(buf[self.pos] - 0x30)
                        self.pos += 1
                    val = 0
                    for d in oct_digits:
                        val = val * 8 + d
                    out.append(val & 0xFF)
                else:
                    out.append(e)
            elif c == 0x28:
                depth += 1
                out.append(c)
            elif c == 0x29:
                depth -= 1
                if depth == 0:
                    break
                out.append(c)
            else:
                out.append(c)
        return bytes(out)

    def _parse_hex_string(self) -> bytes:
        assert self.buf[self.pos] == 0x3C
        self.pos += 1
        hexd = bytearray()
        buf, n = self.buf, len(self.buf)
        while self.pos < n:
            c = buf[self.pos]
            self.pos += 1
            if c == 0x3E:
                break
            if c in WHITESPACE:
                continue
            hexd.append(c)
        if len(hexd) % 2:
            hexd.append(0x30)
        try:
            return bytes.fromhex(hexd.decode("ascii"))
        except ValueError as exc:
            raise PDFError("bad hex string") from exc

    def _parse_dict_or_stream(self) -> Any:
        self.expect(b"<<")
        d: dict = {}
        while True:
            self.skip_ws()
            if self.buf.startswith(b">>", self.pos):
                self.pos += 2
                break
            key = self._parse_name() if self.peek_byte() == 0x2F else None
            if key is None:
                raise PDFError(f"dict key is not a name at {self.pos}")
            d[key] = self.parse_object()
        save = self.pos
        if self.try_keyword(b"stream"):
            # EOL after 'stream' keyword: CRLF or LF
            if self.buf.startswith(b"\r\n", self.pos):
                self.pos += 2
            elif self.buf.startswith(b"\n", self.pos):
                self.pos += 1
            return ("__stream_start__", d, self.pos)
        self.pos = save
        return d


def apply_png_predictor(data: bytes, colors: int, bpc: int, columns: int) -> bytes:
    bpp = max(1, (colors * bpc) // 8)
    row_len = (columns * colors * bpc + 7) // 8
    out = bytearray()
    prev = bytearray(row_len)
    i = 0
    n = len(data)
    while i + 1 <= n:
        ft = data[i]
        i += 1
        row = bytearray(data[i : i + row_len])
        i += row_len
        if len(row) < row_len:
            row.extend(b"\x00" * (row_len - len(row)))
        if ft == 0:
            pass
        elif ft == 1:  # Sub
            for j in range(bpp, row_len):
                row[j] = (row[j] + row[j - bpp]) & 0xFF
        elif ft == 2:  # Up
            for j in range(row_len):
                row[j] = (row[j] + prev[j]) & 0xFF
        elif ft == 3:  # Average
            for j in range(row_len):
                left = row[j - bpp] if j >= bpp else 0
                row[j] = (row[j] + ((left + prev[j]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for j in range(row_len):
                a = row[j - bpp] if j >= bpp else 0
                b = prev[j]
                c = prev[j - bpp] if j >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[j] = (row[j] + pred) & 0xFF
        else:
            raise PDFError(f"unknown PNG predictor filter type {ft}")
        out.extend(row)
        prev = row
    return bytes(out)


def lzw_decode(data: bytes) -> bytes:
    """LZWDecode per the PDF spec (early-change variant)."""
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    code_len = 9
    prev: bytes | None = None
    bitbuf = 0
    nbits = 0
    for byte in data:
        bitbuf = (bitbuf << 8) | byte
        nbits += 8
        while nbits >= code_len:
            nbits -= code_len
            code = (bitbuf >> nbits) & ((1 << code_len) - 1)
            if code == 256:  # clear
                table = table[:258]
                code_len = 9
                prev = None
                continue
            if code == 257:  # EOD
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out.extend(entry)
            prev = entry
            if len(table) + 1 >= (1 << code_len) and code_len < 12:
                code_len += 1
    return bytes(out)


def ascii85_decode(data: bytes) -> bytes:
    data = data.replace(b"\n", b"").replace(b"\r", b"").replace(b" ", b"").replace(b"\t", b"")
    if data.startswith(b"<~"):
        data = data[2:]
    if data.endswith(b"~>"):
        data = data[:-2]
    out = bytearray()
    group: list[int] = []
    for c in data:
        if c == 0x7A and not group:  # 'z' shortcut
            out.extend(b"\x00\x00\x00\x00")
            continue
        group.append(c - 33)
        if len(group) == 5:
            val = 0
            for g in group:
                val = val * 85 + g
            out.extend(val.to_bytes(4, "big"))
            group = []
    if group:
        pad = 5 - len(group)
        val = 0
        for g in group + [84] * pad:
            val = val * 85 + g
        out.extend(val.to_bytes(4, "big")[: 4 - pad])
    return bytes(out)


def runlength_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        length = data[i]
        i += 1
        if length == 128:
            break
        if length < 128:
            out.extend(data[i : i + length + 1])
            i += length + 1
        else:
            if i < n:
                out.extend(bytes([data[i]]) * (257 - length))
                i += 1
    return bytes(out)


def decode_stream(sdict: dict, raw: bytes, doc: "Document | None" = None) -> bytes:
    """Apply the stream's /Filter chain with /DecodeParms."""

    def resolve(x: Any) -> Any:
        return doc.resolve(x) if doc is not None else x

    filters = resolve(sdict.get("Filter"))
    if filters is None:
        return raw
    if not isinstance(filters, list):
        filters = [filters]
    parms = resolve(sdict.get("DecodeParms") or sdict.get("DP"))
    if not isinstance(parms, list):
        parms = [parms] * len(filters)
    data = raw
    for f, p in zip(filters, parms):
        f = resolve(f)
        p = resolve(p) or {}
        if f in ("FlateDecode", "Fl"):
            try:
                data = zlib.decompress(data)
            except zlib.error:
                # tolerate trailing garbage / missing EOD
                try:
                    d = zlib.decompressobj()
                    data = d.decompress(data)
                except zlib.error as exc:
                    raise PDFError(f"flate decode failed: {exc}") from exc
        elif f in ("ASCIIHexDecode", "AHx"):
            data = bytes.fromhex(
                data.replace(b">", b"").translate(None, bytes(WHITESPACE)).decode("ascii")
            )
        elif f in ("ASCII85Decode", "A85"):
            data = ascii85_decode(data)
        elif f in ("RunLengthDecode", "RL"):
            data = runlength_decode(data)
        elif f in ("LZWDecode", "LZW"):
            data = lzw_decode(data)
        elif f in ("DCTDecode", "JPXDecode", "JBIG2Decode", "CCITTFaxDecode"):
            return data  # image data; caller handles / ignores
        elif f == "Crypt":
            raise PDFEncryptedError("Crypt filter unsupported")
        else:
            raise PDFError(f"unsupported filter {f}")
        pred = resolve(p.get("Predictor", 1)) if isinstance(p, dict) else 1
        if pred and pred >= 10:
            data = apply_png_predictor(
                data,
                int(resolve(p.get("Colors", 1))),
                int(resolve(p.get("BitsPerComponent", 8))),
                int(resolve(p.get("Columns", 1))),
            )
        elif pred == 2:
            raise PDFError("TIFF predictor unsupported")
    return data


_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b")


class Document:
    """A parsed PDF: lazy object resolution over xref(s) + object streams."""

    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.xref: dict[int, tuple[int, int]] = {}  # num -> (kind, value): kind 0=offset,1=(objstm)
        self.objstm_pos: dict[int, tuple[int, int]] = {}  # num -> (container_num, idx)
        self.trailer: dict = {}
        self._cache: dict[int, Any] = {}
        self._objstm_cache: dict[int, dict[int, Any]] = {}
        self._parse_xrefs()
        if "Encrypt" in self.trailer:
            raise PDFEncryptedError("encrypted PDF")

    # -- xref parsing ------------------------------------------------------

    def _parse_xrefs(self) -> None:
        tail = self.buf[-2048:]
        m = None
        for m in re.finditer(rb"startxref\s+(\d+)", tail):
            pass
        if m:
            try:
                self._parse_xref_at(int(m.group(1)), set())
                if self.xref and ("Root" in self.trailer):
                    return
            except PDFError:
                pass
        self._brute_scan()
        if not self.trailer.get("Root"):
            # find a trailer dict anywhere
            for tm in re.finditer(rb"trailer", self.buf):
                try:
                    lx = Lexer(self.buf, tm.end())
                    t = lx.parse_object()
                    if isinstance(t, dict) and "Root" in t:
                        for k, v in t.items():
                            self.trailer.setdefault(k, v)
                        break
                except PDFError:
                    continue
        if not self.trailer.get("Root"):
            # xref-stream documents: find the object with /Type /Catalog
            for num in list(self.xref):
                try:
                    obj = self.get_object(num)
                except PDFError:
                    continue
                if isinstance(obj, dict) and obj.get("Type") == "Catalog":
                    self.trailer["Root"] = Ref(num, 0)
                    break
        if not self.trailer.get("Root"):
            raise PDFError("no document catalog found")

    def _parse_xref_at(self, offset: int, seen: set[int]) -> None:
        if offset in seen or offset >= len(self.buf):
            return
        seen.add(offset)
        lx = Lexer(self.buf, offset)
        lx.skip_ws()
        if lx.buf.startswith(b"xref", lx.pos):
            lx.pos += 4
            self._parse_xref_table(lx, seen)
        else:
            self._parse_xref_stream(lx, seen)

    def _parse_xref_table(self, lx: Lexer, seen: set[int]) -> None:
        while True:
            lx.skip_ws()
            m = re.match(rb"(\d+)\s+(\d+)", lx.buf[lx.pos : lx.pos + 40])
            if not m:
                break
            first, count = int(m.group(1)), int(m.group(2))
            lx.pos += m.end()
            lx.skip_ws()
            for i in range(count):
                ent = self.buf[lx.pos : lx.pos + 20]
                em = re.match(rb"(\d{10})\s(\d{5})\s([nf])", ent)
                if not em:
                    raise PDFError(f"bad xref entry at {lx.pos}")
                if em.group(3) == b"n":
                    self.xref.setdefault(first + i, (0, int(em.group(1))))
                # entries are 20 bytes, but tolerate 19 (bad writers)
                adv = 20 if ent[19:20] in (b"", b"\n", b"\r", b" ") and len(ent) == 20 else 19
                lx.pos += adv
            lx.skip_ws()
            if lx.buf.startswith(b"trailer", lx.pos):
                lx.pos += 7
                t = lx.parse_object()
                for k, v in t.items():
                    self.trailer.setdefault(k, v)
                if "XRefStm" in t:
                    self._parse_xref_at(int(t["XRefStm"]), seen)
                if "Prev" in t:
                    self._parse_xref_at(int(self.resolve(t["Prev"])), seen)
                return

    def _parse_xref_stream(self, lx: Lexer, seen: set[int]) -> None:
        m = _OBJ_RE.match(lx.buf, lx.pos) or _OBJ_RE.search(lx.buf, lx.pos, lx.pos + 100)
        if not m:
            raise PDFError("no xref stream object header")
        lx.pos = m.end()
        obj = lx.parse_object()
        if not (isinstance(obj, tuple) and obj[0] == "__stream_start__"):
            raise PDFError("xref offset does not point at a stream")
        sdict, start = obj[1], obj[2]
        length = sdict.get("Length")
        if isinstance(length, Ref):
            length = self._resolve_early_length(length)
        raw = self.buf[start : start + int(length)]
        data = decode_stream(sdict, raw, None)
        w = [int(x) for x in sdict["W"]]
        size = int(sdict["Size"])
        index = sdict.get("Index", [0, size])
        index = [int(x) for x in index]
        rowlen = sum(w)
        pos = 0
        for ii in range(0, len(index), 2):
            first, count = index[ii], index[ii + 1]
            for i in range(count):
                row = data[pos : pos + rowlen]
                pos += rowlen
                if len(row) < rowlen:
                    break
                fields = []
                off = 0
                for width in w:
                    if width == 0:
                        fields.append(1 if len(fields) == 0 else 0)
                    else:
                        fields.append(int.from_bytes(row[off : off + width], "big"))
                        off += width
                ftype, f2, f3 = fields[0], fields[1], fields[2] if len(fields) > 2 else 0
                num = first + i
                if num in self.xref or num in self.objstm_pos:
                    continue
                if ftype == 1:
                    self.xref[num] = (0, f2)
                elif ftype == 2:
                    self.objstm_pos[num] = (f2, f3)
        for k, v in sdict.items():
            if k not in ("W", "Index", "Filter", "DecodeParms", "Length", "Type"):
                self.trailer.setdefault(k, v)
        if "Prev" in sdict:
            self._parse_xref_at(int(sdict["Prev"]), seen)

    def _resolve_early_length(self, ref: Ref) -> int:
        """Resolve a /Length reference before the xref map is complete."""
        for m in _OBJ_RE.finditer(self.buf):
            if int(m.group(1)) == ref.num:
                lx = Lexer(self.buf, m.end())
                v = lx.parse_object()
                if isinstance(v, (int, float)):
                    return int(v)
        raise PDFError(f"cannot resolve stream /Length {ref}")

    def _brute_scan(self) -> None:
        """Recovery: scan the whole file for 'N G obj' headers."""
        for m in _OBJ_RE.finditer(self.buf):
            self.xref[int(m.group(1))] = (0, m.start())

    # -- object access -----------------------------------------------------

    def resolve(self, obj: Any) -> Any:
        depth = 0
        while isinstance(obj, Ref) and depth < 32:
            obj = self.get_object(obj.num)
            depth += 1
        return obj

    def get_object(self, num: int) -> Any:
        if num in self._cache:
            return self._cache[num]
        obj: Any = None
        if num in self.xref:
            kind, offset = self.xref[num]
            obj = self._parse_object_at(offset, num)
        elif num in self.objstm_pos:
            container, idx = self.objstm_pos[num]
            obj = self._objstm_object(container, num)
        self._cache[num] = obj
        return obj

    def _parse_object_at(self, offset: int, expect_num: int) -> Any:
        m = _OBJ_RE.match(self.buf, offset)
        if not m:
            m = _OBJ_RE.search(self.buf, max(0, offset - 64), offset + 512)
            if not m:
                return None
        lx = Lexer(self.buf, m.end())
        try:
            obj = lx.parse_object()
        except PDFError:
            return None
        if isinstance(obj, tuple) and obj[0] == "__stream_start__":
            sdict, start = obj[1], obj[2]
            length = self.resolve(sdict.get("Length"))
            if not isinstance(length, (int, float)):
                # recover by searching endstream
                end = self.buf.find(b"endstream", start)
                length = max(0, end - start)
            end = start + int(length)
            raw = self.buf[start:end]
            # some writers lie about Length; trim to endstream if needed
            if b"endstream" not in self.buf[end : end + 32]:
                es = self.buf.find(b"endstream", start)
                if es != -1:
                    raw = self.buf[start:es].rstrip(b"\r\n")
            return Stream(sdict, raw, self)
        return obj

    def _objstm_object(self, container_num: int, want: int) -> Any:
        if container_num not in self._objstm_cache:
            stm = self.resolve(Ref(container_num, 0))
            if not isinstance(stm, Stream):
                return None
            data = stm.data()
            n = int(self.resolve(stm.dict["N"]))
            first = int(self.resolve(stm.dict["First"]))
            header = Lexer(data, 0)
            pairs = []
            for _ in range(n):
                header.skip_ws()
                onum = header.parse_object()
                ooff = header.parse_object()
                pairs.append((int(onum), int(ooff)))
            objs: dict[int, Any] = {}
            for onum, ooff in pairs:
                try:
                    objs[onum] = Lexer(data, first + ooff).parse_object()
                except PDFError:
                    objs[onum] = None
            self._objstm_cache[container_num] = objs
        return self._objstm_cache[container_num].get(want)

    # -- page tree ---------------------------------------------------------

    def catalog(self) -> dict:
        root = self.resolve(self.trailer["Root"])
        if not isinstance(root, dict):
            raise PDFError("bad catalog")
        return root

    def pages(self) -> list[dict]:
        """Flattened page dicts with inherited attributes resolved."""
        cat = self.catalog()
        tree = self.resolve(cat.get("Pages"))
        out: list[dict] = []
        if not isinstance(tree, dict):
            return out
        inheritable = ("Resources", "MediaBox", "CropBox", "Rotate")
        stack: list[tuple[Any, dict]] = [(tree, {})]
        seen: set[int] = set()
        while stack:
            node_ref, inherited = stack.pop()
            node = self.resolve(node_ref)
            if not isinstance(node, dict):
                continue
            nid = id(node)
            if nid in seen:
                continue
            seen.add(nid)
            inh = dict(inherited)
            for k in inheritable:
                if k in node:
                    inh[k] = node[k]
            if node.get("Type") == "Page" or ("Contents" in node and "Kids" not in node):
                page = dict(node)
                for k, v in inh.items():
                    page.setdefault(k, v)
                out.append(page)
            else:
                kids = self.resolve(node.get("Kids")) or []
                for kid in reversed(kids):
                    stack.append((kid, inh))
        return out


def open_pdf(path_or_bytes) -> Document:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    if not buf.lstrip()[:5].startswith(b"%PDF-"):
        # tolerate leading junk if a %PDF- header exists within 1 KiB
        idx = buf.find(b"%PDF-")
        if idx == -1 or idx > 1024:
            raise PDFError("not a PDF (missing %PDF- header)")
        buf = buf[idx:]
    return Document(buf)

"""Vendored minimal .docx and .pdf text extraction (stdlib only).

The reference extracts docx text via python-docx and pdf text via pypdf
with a quality-gated OCR fallback (reference: app/ingest_adapters.py:
131-182, 167-293). Neither library ships in this image, so the adapter
layer falls back to these extractors:

- ``docx_to_text``: a .docx is a zip; the body is ``word/document.xml``.
  Paragraph text is the concatenation of ``w:t`` runs (tabs/breaks
  normalized), in document order — the same output shape python-docx's
  ``document.paragraphs`` gives the reference.
- ``pdf_to_text``: a deliberately small parser for *digital* PDFs (text
  layers present). Handles classic xref and object streams (ObjStm),
  FlateDecode, page-tree walking, content-stream text operators
  (Tj / ' / " / TJ), literal + hex strings, and per-font ToUnicode CMaps
  (bfchar/bfrange) so CID-keyed fonts decode correctly. Scanned PDFs
  (no text operators) return "" — the adapter's OCR gate takes over,
  matching the reference's quality-gate semantics.

This is not a general PDF library: unsupported filters (DCT, LZW, ...)
are skipped per-stream rather than fatal, and layout is reduced to
newline heuristics (Td/TD/T*/Tm vertical moves).
"""

from __future__ import annotations

import re
import zlib
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple
from xml.etree import ElementTree


class ExtractionError(ValueError):
    pass


# ------------------------------------------------------------------ docx ----

_W_NS = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"


def docx_to_text(path: Path) -> str:
    """Paragraph texts (incl. table-cell paragraphs) joined by blank lines."""
    try:
        with zipfile.ZipFile(path) as zf:
            raw = zf.read("word/document.xml")
    except (zipfile.BadZipFile, KeyError, OSError) as exc:
        raise ExtractionError(f"not a readable docx: {exc}") from exc
    try:
        root = ElementTree.fromstring(raw)
    except ElementTree.ParseError as exc:
        raise ExtractionError(f"docx body is not valid XML: {exc}") from exc
    paragraphs: List[str] = []
    for p in root.iter(_W_NS + "p"):
        parts: List[str] = []
        for node in p.iter():
            if node.tag == _W_NS + "t":
                parts.append(node.text or "")
            elif node.tag == _W_NS + "tab":
                parts.append("\t")
            elif node.tag in (_W_NS + "br", _W_NS + "cr"):
                parts.append("\n")
        text = "".join(parts).strip()
        if text:
            paragraphs.append(text)
    return "\n\n".join(paragraphs)


# ------------------------------------------------------------------- pdf ----

class _Ref:
    __slots__ = ("num",)

    def __init__(self, num: int):
        self.num = num


class _Name(str):
    pass


class _Op(str):
    """A bare content-stream operator token (Tj, TJ, Td, ...) — distinct
    from _Name so ``/F2`` operands are never mistaken for operators."""


_WS = b"\x00\t\n\x0c\r "
_DELIM = b"()<>[]{}/%"


class _Lexer:
    """Tokenizer over a PDF object / content-stream byte buffer."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def _skip_ws(self) -> None:
        data, n = self.data, len(self.data)
        while self.pos < n:
            c = data[self.pos]
            if c in _WS:
                self.pos += 1
            elif c == 0x25:  # '%' comment to EOL
                while self.pos < n and data[self.pos] not in b"\r\n":
                    self.pos += 1
            else:
                return

    def peek_bytes(self, k: int) -> bytes:
        self._skip_ws()
        return self.data[self.pos:self.pos + k]

    def parse_object(self) -> Any:
        """Parse one PDF object value starting at pos."""
        self._skip_ws()
        data, n = self.data, len(self.data)
        if self.pos >= n:
            raise ExtractionError("unexpected end of pdf data")
        c = data[self.pos]
        if data.startswith(b"<<", self.pos):
            return self._parse_dict()
        if c == 0x3C:  # '<' hex string
            return self._parse_hex_string()
        if c == 0x28:  # '('
            return self._parse_literal_string()
        if c == 0x5B:  # '['
            return self._parse_array()
        if c == 0x2F:  # '/'
            return self._parse_name()
        if data.startswith(b"true", self.pos):
            self.pos += 4
            return True
        if data.startswith(b"false", self.pos):
            self.pos += 5
            return False
        if data.startswith(b"null", self.pos):
            self.pos += 4
            return None
        return self._parse_number_or_ref()

    def _parse_dict(self) -> Dict[str, Any]:
        self.pos += 2
        out: Dict[str, Any] = {}
        while True:
            self._skip_ws()
            if self.data.startswith(b">>", self.pos):
                self.pos += 2
                return out
            key = self.parse_object()
            if not isinstance(key, _Name):
                raise ExtractionError("pdf dict key is not a name")
            out[str(key)] = self.parse_object()

    def _parse_array(self) -> List[Any]:
        self.pos += 1
        out: List[Any] = []
        while True:
            self._skip_ws()
            if self.pos < len(self.data) and self.data[self.pos] == 0x5D:
                self.pos += 1
                return out
            out.append(self.parse_object())

    def _parse_name(self) -> _Name:
        self.pos += 1
        start = self.pos
        data, n = self.data, len(self.data)
        while self.pos < n and data[self.pos] not in _WS and data[self.pos] not in _DELIM:
            self.pos += 1
        raw = data[start:self.pos]
        # '#xx' escapes inside names
        def unescape(m):
            return bytes([int(m.group(1), 16)])
        raw = re.sub(rb"#([0-9A-Fa-f]{2})", unescape, raw)
        return _Name(raw.decode("latin-1"))

    def _parse_literal_string(self) -> bytes:
        self.pos += 1
        data, n = self.data, len(self.data)
        out = bytearray()
        depth = 1
        while self.pos < n:
            c = data[self.pos]
            if c == 0x5C:  # backslash
                self.pos += 1
                if self.pos >= n:
                    break
                e = data[self.pos]
                mapping = {0x6E: 0x0A, 0x72: 0x0D, 0x74: 0x09,
                           0x62: 0x08, 0x66: 0x0C, 0x28: 0x28,
                           0x29: 0x29, 0x5C: 0x5C}
                if e in mapping:
                    out.append(mapping[e])
                    self.pos += 1
                elif 0x30 <= e <= 0x37:  # octal, up to 3 digits
                    digits = bytearray()
                    while (self.pos < n and len(digits) < 3
                           and 0x30 <= data[self.pos] <= 0x37):
                        digits.append(data[self.pos])
                        self.pos += 1
                    out.append(int(digits.decode(), 8) & 0xFF)
                elif e in b"\r\n":  # line continuation
                    self.pos += 1
                    if e == 0x0D and self.pos < n and data[self.pos] == 0x0A:
                        self.pos += 1
                else:
                    out.append(e)
                    self.pos += 1
                continue
            if c == 0x28:
                depth += 1
            elif c == 0x29:
                depth -= 1
                if depth == 0:
                    self.pos += 1
                    return bytes(out)
            out.append(c)
            self.pos += 1
        return bytes(out)

    def _parse_hex_string(self) -> bytes:
        self.pos += 1
        end = self.data.find(b">", self.pos)
        if end < 0:
            raise ExtractionError("unterminated hex string")
        hexes = re.sub(rb"[^0-9A-Fa-f]", b"", self.data[self.pos:end])
        self.pos = end + 1
        if len(hexes) % 2:
            hexes += b"0"
        return bytes.fromhex(hexes.decode())

    def _parse_number_or_ref(self) -> Any:
        data, n = self.data, len(self.data)
        start = self.pos
        while self.pos < n and data[self.pos] in b"+-.0123456789":
            self.pos += 1
        raw = data[start:self.pos]
        if not raw:
            # unknown token (content-stream operator etc.) — let caller
            # handle; consume one regular token
            while self.pos < n and data[self.pos] not in _WS and data[self.pos] not in _DELIM:
                self.pos += 1
            if self.pos == start:  # stray delimiter — must make progress
                self.pos += 1
            return _Op(data[start:self.pos].decode("latin-1"))
        if b"." in raw:
            return float(raw)
        value = int(raw)
        # lookahead for "gen R" making this an indirect reference
        save = self.pos
        self._skip_ws()
        m = re.match(rb"(\d+)\s+R\b", data[self.pos:self.pos + 24])
        if m and raw[:1] not in b"+-.":
            self.pos += m.end()
            return _Ref(value)
        self.pos = save
        return value


def _decode_stream(info: Dict[str, Any], raw: bytes) -> Optional[bytes]:
    """Apply the stream's filter chain; None when a filter is unsupported."""
    filters = info.get("Filter")
    if filters is None:
        return raw
    if not isinstance(filters, list):
        filters = [filters]
    data = raw
    for f in filters:
        name = str(f)
        if name in ("FlateDecode", "Fl"):
            try:
                data = zlib.decompress(data)
            except zlib.error:
                try:  # tolerate trailing garbage
                    data = zlib.decompressobj().decompress(data)
                except zlib.error:
                    return None
        elif name in ("ASCIIHexDecode", "AHx"):
            hexes = re.sub(rb"[^0-9A-Fa-f]", b"", data.split(b">")[0])
            if len(hexes) % 2:
                hexes += b"0"
            data = bytes.fromhex(hexes.decode())
        else:
            return None  # DCTDecode (images), LZW, ... — skip this stream
    params = info.get("DecodeParms") or info.get("DP")
    if isinstance(params, dict) and params.get("Predictor", 1) > 1:
        data = _undo_png_predictor(
            data, int(params.get("Columns", 1)),
            int(params.get("Colors", 1)) * (int(params.get("BitsPerComponent", 8)) // 8),
        )
    return data


def _undo_png_predictor(data: bytes, columns: int, bpp: int) -> bytes:
    """PNG row predictors (used by xref streams)."""
    row_len = columns * bpp
    out = bytearray()
    prev = bytearray(row_len)
    i = 0
    while i + 1 + row_len <= len(data) + row_len and i < len(data):
        tag = data[i]
        row = bytearray(data[i + 1:i + 1 + row_len])
        i += 1 + row_len
        if tag == 1:   # Sub
            for j in range(bpp, len(row)):
                row[j] = (row[j] + row[j - bpp]) & 0xFF
        elif tag == 2:  # Up
            for j in range(len(row)):
                row[j] = (row[j] + prev[j]) & 0xFF
        elif tag == 3:  # Average
            for j in range(len(row)):
                left = row[j - bpp] if j >= bpp else 0
                row[j] = (row[j] + ((left + prev[j]) >> 1)) & 0xFF
        elif tag == 4:  # Paeth
            for j in range(len(row)):
                a = row[j - bpp] if j >= bpp else 0
                b = prev[j]
                c = prev[j - bpp] if j >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[j] = (row[j] + pred) & 0xFF
        out.extend(row)
        prev = row
    return bytes(out)


class _PdfDocument:
    def __init__(self, data: bytes):
        self.data = data
        # (value, decoded_stream_or_None) per object number
        self.objects: Dict[int, Tuple[Any, Optional[bytes]]] = {}
        self._scan_objects()
        self._expand_object_streams()

    # -- object discovery -------------------------------------------------
    def _scan_objects(self) -> None:
        """Byte-scan for ``N G obj`` — robust to broken/absent xref tables
        (the common failure mode of minimal parsers)."""
        for m in re.finditer(rb"(\d+)\s+(\d+)\s+obj\b", self.data):
            num = int(m.group(1))
            lexer = _Lexer(self.data, m.end())
            try:
                value = lexer.parse_object()
            except ExtractionError:
                continue
            stream: Optional[bytes] = None
            if isinstance(value, dict) and lexer.peek_bytes(6) == b"stream":
                start = self.data.find(b"stream", lexer.pos) + len(b"stream")
                if self.data[start:start + 2] == b"\r\n":
                    start += 2
                elif self.data[start:start + 1] in (b"\n", b"\r"):
                    start += 1
                length = value.get("Length")
                if isinstance(length, _Ref):
                    length = None  # resolved below via endstream search
                if isinstance(length, int):
                    raw = self.data[start:start + length]
                    # trust Length only if endstream actually follows
                    tail = self.data[start + length:start + length + 16]
                    if b"endstream" not in tail:
                        length = None
                if not isinstance(length, int):
                    end = self.data.find(b"endstream", start)
                    raw = self.data[start:end if end >= 0 else len(self.data)]
                    raw = raw.rstrip(b"\r\n")
                stream = _decode_stream(value, raw)
            self.objects[num] = (value, stream)

    def _expand_object_streams(self) -> None:
        """Pull compressed objects out of /Type /ObjStm containers."""
        for value, stream in list(self.objects.values()):
            if (not isinstance(value, dict) or stream is None
                    or str(value.get("Type", "")) != "ObjStm"):
                continue
            count = value.get("N")
            first = value.get("First")
            if not isinstance(count, int) or not isinstance(first, int):
                continue
            header = stream[:first].split()
            body = stream
            for i in range(count):
                try:
                    num = int(header[2 * i])
                    off = int(header[2 * i + 1])
                except (IndexError, ValueError):
                    break
                lexer = _Lexer(body, first + off)
                try:
                    inner = lexer.parse_object()
                except ExtractionError:
                    continue
                self.objects.setdefault(num, (inner, None))

    # -- resolution --------------------------------------------------------
    def resolve(self, obj: Any, depth: int = 0) -> Any:
        while isinstance(obj, _Ref) and depth < 32:
            obj = self.objects.get(obj.num, (None, None))[0]
            depth += 1
        return obj

    def stream_of(self, obj: Any) -> Optional[bytes]:
        if isinstance(obj, _Ref):
            return self.objects.get(obj.num, (None, None))[1]
        return None

    # -- pages ---------------------------------------------------------------
    def pages(self) -> List[Dict[str, Any]]:
        """Page dicts in page-tree order; falls back to appearance order."""
        root_pages = None
        for value, _ in self.objects.values():
            if isinstance(value, dict) and str(value.get("Type", "")) == "Catalog":
                root_pages = self.resolve(value.get("Pages"))
                break
        out: List[Dict[str, Any]] = []
        seen: set = set()

        def walk(node: Any, depth: int = 0) -> None:
            node = self.resolve(node)
            if not isinstance(node, dict) or depth > 64 or id(node) in seen:
                return
            seen.add(id(node))
            t = str(node.get("Type", ""))
            if t == "Page":
                out.append(node)
            else:
                for kid in self.resolve(node.get("Kids")) or []:
                    walk(kid, depth + 1)

        if root_pages is not None:
            walk(root_pages)
        if not out:
            out = [v for v, _ in self.objects.values()
                   if isinstance(v, dict) and str(v.get("Type", "")) == "Page"]
        return out

    # -- fonts / ToUnicode ---------------------------------------------------
    def font_cmaps(self, page: Dict[str, Any]) -> Dict[str, Tuple[Dict[int, str], int]]:
        """font resource name -> (code->text map, code byte width)."""
        res = self.resolve(page.get("Resources")) or {}
        fonts = self.resolve(res.get("Font")) or {}
        out: Dict[str, Tuple[Dict[int, str], int]] = {}
        if not isinstance(fonts, dict):
            return out
        for name, ref in fonts.items():
            font = self.resolve(ref)
            if not isinstance(font, dict):
                continue
            tounicode = font.get("ToUnicode")
            data = self.stream_of(tounicode)
            if data is None and isinstance(self.resolve(tounicode), dict):
                continue
            if data:
                cmap, width = _parse_tounicode(data)
                if cmap:
                    out[str(name)] = (cmap, width)
        return out

    # -- page text -------------------------------------------------------------
    def page_text(self, page: Dict[str, Any]) -> str:
        contents = page.get("Contents")
        streams: List[bytes] = []
        for item in (contents if isinstance(self.resolve(contents), list)
                     else [contents]):
            resolved_list = self.resolve(item)
            if isinstance(resolved_list, list):
                for sub in resolved_list:
                    s = self.stream_of(sub)
                    if s:
                        streams.append(s)
                continue
            s = self.stream_of(item)
            if s:
                streams.append(s)
        if not streams:
            return ""
        return _content_text(b"\n".join(streams), self.font_cmaps(page))


def _parse_tounicode(data: bytes) -> Tuple[Dict[int, str], int]:
    cmap: Dict[int, str] = {}
    width = 1

    def utf16(hexstr: bytes) -> str:
        try:
            return bytes.fromhex(hexstr.decode()).decode("utf-16-be")
        except (ValueError, UnicodeDecodeError):
            return ""

    for m in re.finditer(rb"begincodespacerange(.*?)endcodespacerange",
                         data, re.S):
        lo = re.search(rb"<([0-9A-Fa-f]+)>", m.group(1))
        if lo:
            width = max(1, len(lo.group(1)) // 2)
    for m in re.finditer(rb"beginbfchar(.*?)endbfchar", data, re.S):
        for src, dst in re.findall(
                rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>", m.group(1)):
            cmap[int(src, 16)] = utf16(dst)
            width = max(width, len(src) // 2)
    for m in re.finditer(rb"beginbfrange(.*?)endbfrange", data, re.S):
        body = m.group(1)
        for lo, hi, dst in re.findall(
                rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>",
                body):
            lo_i, hi_i = int(lo, 16), int(hi, 16)
            base = int(dst, 16)
            width = max(width, len(lo) // 2)
            for code in range(lo_i, min(hi_i, lo_i + 65535) + 1):
                cmap[code] = utf16(
                    (b"%0*x" % (len(dst), base + code - lo_i)))
        for lo, hi, arr in re.findall(
                rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*\[(.*?)\]",
                body, re.S):
            lo_i = int(lo, 16)
            width = max(width, len(lo) // 2)
            for j, dst in enumerate(re.findall(rb"<([0-9A-Fa-f]+)>", arr)):
                cmap[lo_i + j] = utf16(dst)
    return cmap, width


def _decode_text(raw: bytes, cmap: Optional[Tuple[Dict[int, str], int]]) -> str:
    if cmap is None:
        return raw.decode("latin-1", errors="replace")
    table, width = cmap
    out: List[str] = []
    for i in range(0, len(raw) - width + 1, width):
        code = int.from_bytes(raw[i:i + width], "big")
        if code in table:
            out.append(table[code])
        elif width == 1:
            out.append(chr(code))
    return "".join(out)


def _content_text(
    content: bytes, cmaps: Dict[str, Tuple[Dict[int, str], int]]
) -> str:
    """Walk content-stream tokens, keeping text-showing operators."""
    lexer = _Lexer(content)
    stack: List[Any] = []
    parts: List[str] = []
    font: Optional[Tuple[Dict[int, str], int]] = None
    n = len(content)
    while True:
        lexer._skip_ws()
        if lexer.pos >= n:
            break
        try:
            tok = lexer.parse_object()
        except ExtractionError:
            break
        if isinstance(tok, _Op):
            op = str(tok)
            if op == "Tf" and stack:
                name = stack[-2] if len(stack) >= 2 else None
                font = cmaps.get(str(name)) if name is not None else None
                stack.clear()
            elif op == "Tj" and stack and isinstance(stack[-1], bytes):
                parts.append(_decode_text(stack[-1], font))
                stack.clear()
            elif op in ("'", '"'):
                raw = next((s for s in reversed(stack)
                            if isinstance(s, bytes)), None)
                parts.append("\n")
                if raw is not None:
                    parts.append(_decode_text(raw, font))
                stack.clear()
            elif op == "TJ" and stack and isinstance(stack[-1], list):
                for item in stack[-1]:
                    if isinstance(item, bytes):
                        parts.append(_decode_text(item, font))
                    elif isinstance(item, (int, float)) and item < -150:
                        parts.append(" ")  # large kern ~= word gap
                stack.clear()
            elif op in ("Td", "TD", "T*", "Tm"):
                # vertical text-position moves start a new line
                if op == "T*" or (
                    op in ("Td", "TD") and len(stack) >= 1
                    and isinstance(stack[-1], (int, float)) and stack[-1] != 0
                ) or op == "Tm":
                    if parts and not parts[-1].endswith("\n"):
                        parts.append("\n")
                stack.clear()
            elif op in ("BT", "ET"):
                stack.clear()
            elif op == "BI":
                # inline image: skip to EI
                end = content.find(b"EI", lexer.pos)
                lexer.pos = end + 2 if end >= 0 else n
                stack.clear()
            else:
                # any other operator consumes its operands
                stack.clear()
        else:
            stack.append(tok)
            if len(stack) > 64:
                del stack[:-8]
    text = "".join(parts)
    text = re.sub(r"[ \t]+\n", "\n", text)
    return re.sub(r"\n{3,}", "\n\n", text).strip()


def pdf_to_text(path: Path, max_pages: int = 50) -> str:
    """Text of the first ``max_pages`` pages, pages separated by blank
    lines. Scanned/image-only pages contribute nothing (caller applies the
    OCR quality gate, mirroring the reference's _should_run_pdf_ocr)."""
    data = Path(path).read_bytes()
    if not data.lstrip()[:5].startswith(b"%PDF-"):
        raise ExtractionError("not a pdf (missing %PDF header)")
    doc = _PdfDocument(data)
    pages = doc.pages()[:max_pages]
    if not pages:
        return ""
    texts = [doc.page_text(p) for p in pages]
    return "\n\n".join(t for t in texts if t).strip()

"""Self-contained document text extraction (stdlib only).

The reference parses PDFs/DOCX/PPTX through heavyweight optional
dependencies (``unstructured``, ``docling``, ``pypdf`` —
the reference's ``python/pathway/xpacks/llm/parsers.py``).  None of those
ship in this image, so DocumentStore could not ingest real documents.
These extractors cover the dominant formats with the standard library:

* PDF text lives mostly in FlateDecode content streams whose text
  operators (``Tj``/``TJ``/``'``/``"``) carry the strings — a small
  object parser + ``zlib`` recovers them per page;
* DOCX/PPTX are zip archives of WordprocessingML / PresentationML — the
  text is the ``<w:t>`` / ``<a:t>`` runs of ``word/document.xml`` /
  ``ppt/slides/slideN.xml``.

Scope: text extraction for standard one-byte encodings (the classic PDF
base fonts); embedded-CMap subset fonts decode best-effort.  That matches
what the fixture corpus and typical machine-generated reports need.
"""

from __future__ import annotations

import io
import re
import zipfile
import zlib
from xml.etree import ElementTree as ET

# ---------------------------------------------------------------------------
# PDF
# ---------------------------------------------------------------------------

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b(.*?)endobj", re.S)
_STREAM_RE = re.compile(rb"stream\r?\n(.*?)\r?\nendstream", re.S)
_REF_RE = re.compile(rb"/Contents\s*(?:(\d+)\s+\d+\s+R|\[(.*?)\])", re.S)
_KIDS_RE = re.compile(rb"/Kids\s*\[(.*?)\]", re.S)
_NUM_REF_RE = re.compile(rb"(\d+)\s+\d+\s+R")


class PdfError(ValueError):
    pass


def _parse_objects(data: bytes) -> dict[int, bytes]:
    objs: dict[int, bytes] = {}
    for m in _OBJ_RE.finditer(data):
        objs[int(m.group(1))] = m.group(3)
    if not objs:
        raise PdfError("no PDF objects found")
    return objs


def _object_stream(body: bytes) -> bytes | None:
    m = _STREAM_RE.search(body)
    if m is None:
        return None
    raw = m.group(1)
    if b"/FlateDecode" in body[: m.start()]:
        try:
            return zlib.decompress(raw)
        except zlib.error as exc:
            raise PdfError(f"bad FlateDecode stream: {exc}") from None
    return raw


def _page_objects(objs: dict[int, bytes]) -> list[int]:
    """Page object numbers in page-tree order (fallback: document order)."""
    pages_nodes = {
        num
        for num, body in objs.items()
        if b"/Type" in body and re.search(rb"/Type\s*/Pages\b", body)
    }
    # intermediate /Pages nodes are Kids of another /Pages node — walking
    # them as roots would extract their subtree once per ancestor
    kids_of_pages: set[int] = set()
    for num in pages_nodes:
        kids = _KIDS_RE.search(objs[num])
        if kids:
            kids_of_pages.update(
                int(r.group(1)) for r in _NUM_REF_RE.finditer(kids.group(1))
            )
    roots = sorted(pages_nodes - kids_of_pages) or sorted(pages_nodes)
    pages_in_order: list[int] = []
    visited: set[int] = set()

    def walk(num: int) -> None:
        if num in visited:
            return
        visited.add(num)
        body = objs.get(num)
        if body is None:
            return
        if re.search(rb"/Type\s*/Page\b(?!s)", body):
            pages_in_order.append(num)
            return
        kids = _KIDS_RE.search(body)
        if kids:
            for ref in _NUM_REF_RE.finditer(kids.group(1)):
                walk(int(ref.group(1)))

    for root in roots:
        walk(root)
    if not pages_in_order:
        pages_in_order = [
            num
            for num, body in sorted(objs.items())
            if re.search(rb"/Type\s*/Page\b(?!s)", body)
        ]
    return pages_in_order


_ESCAPES = {
    ord("n"): "\n",
    ord("r"): "\r",
    ord("t"): "\t",
    ord("b"): "\b",
    ord("f"): "\f",
    ord("("): "(",
    ord(")"): ")",
    ord("\\"): "\\",
}


def _content_text(stream: bytes) -> str:
    """Pull the text operators out of one decoded content stream.

    Handles literal strings (with escapes and octal), hex strings, the
    ``Tj``/``'``/``"``/``TJ`` show operators, and emits newlines at the
    line-movement operators (``Td``/``TD``/``T*``) and text-object ends.
    TJ kerning numbers below -200/1000 em are rendered as a space (the
    convention most extractors use for inter-word gaps).
    """
    out: list[str] = []
    # operands in order: ("s", text) or ("n", number) — TJ needs the
    # interleaving to know which kerning gap sits between which strings
    operands: list[tuple[str, object]] = []
    i, n = 0, len(stream)

    def newline() -> None:
        if out and not out[-1].endswith("\n"):
            out.append("\n")

    while i < n:
        c = stream[i : i + 1]
        if c == b"(":
            depth = 1
            i += 1
            buf: list[str] = []
            while i < n and depth:
                b = stream[i]
                if b == 0x5C:  # backslash
                    i += 1
                    if i >= n:
                        break
                    e = stream[i]
                    if 0x30 <= e <= 0x37:  # octal, up to 3 digits
                        oct_digits = chr(e)
                        for _ in range(2):
                            if i + 1 < n and 0x30 <= stream[i + 1] <= 0x37:
                                i += 1
                                oct_digits += chr(stream[i])
                        buf.append(chr(int(oct_digits, 8)))
                    elif e in _ESCAPES:
                        buf.append(_ESCAPES[e])
                    elif e in (0x0A, 0x0D):
                        pass  # line continuation
                    else:
                        buf.append(chr(e))
                    i += 1
                    continue
                if b == 0x28:
                    depth += 1
                elif b == 0x29:
                    depth -= 1
                    if depth == 0:
                        i += 1
                        break
                buf.append(chr(b))
                i += 1
            operands.append(("s", "".join(buf)))
            continue
        if c == b"<" and stream[i : i + 2] != b"<<":
            j = stream.find(b">", i)
            if j < 0:
                break
            hexstr = re.sub(rb"\s", b"", stream[i + 1 : j])
            if len(hexstr) % 2:
                hexstr += b"0"
            try:
                operands.append(
                    ("s", bytes.fromhex(hexstr.decode()).decode("latin-1"))
                )
            except ValueError:
                pass
            i = j + 1
            continue
        if c == b"[":
            i += 1
            continue
        if c == b"]":
            i += 1
            continue
        m = re.match(rb"[-+]?\d*\.?\d+", stream[i : i + 24])
        if m and m.group(0) not in (b"", b"-", b"+"):
            try:
                operands.append(("n", float(m.group(0))))
            except ValueError:
                pass
            i += len(m.group(0))
            continue
        m = re.match(rb"[A-Za-z'\"*]+", stream[i : i + 8])
        if m:
            op = m.group(0)
            if op in (b"Tj", b"'", b'"'):
                if op != b"Tj":
                    newline()
                out.extend(str(v) for kind, v in operands if kind == "s")
            elif op == b"TJ":
                # kerning below -200/1000 em reads as an inter-word gap
                for kind, v in operands:
                    if kind == "s":
                        out.append(str(v))
                    elif float(v) < -200:
                        if out and not out[-1].endswith((" ", "\n")):
                            out.append(" ")
            elif op in (b"Td", b"TD", b"T*", b"ET"):
                newline()
            operands = []
            i += len(op)
            continue
        i += 1
    return "".join(out)


def pdf_extract_pages(data: bytes) -> list[str]:
    """Extract text per page from a PDF byte string."""
    if not data.startswith(b"%PDF"):
        raise PdfError("not a PDF (missing %PDF header)")
    objs = _parse_objects(data)
    pages: list[str] = []
    for num in _page_objects(objs):
        body = objs[num]
        content_ids: list[int] = []
        m = _REF_RE.search(body)
        if m:
            if m.group(1):
                content_ids.append(int(m.group(1)))
            else:
                content_ids.extend(
                    int(r.group(1)) for r in _NUM_REF_RE.finditer(m.group(2))
                )
        # the single-ref form may point at an array object of stream refs
        # (the legal indirect-array variant) — expand one level
        expanded: list[int] = []
        for cid in content_ids:
            body_c = objs.get(cid, b"")
            if b"stream" not in body_c and body_c.strip().startswith(b"["):
                expanded.extend(
                    int(r.group(1)) for r in _NUM_REF_RE.finditer(body_c)
                )
            else:
                expanded.append(cid)
        texts = []
        for cid in expanded:
            if cid in objs:
                stream = _object_stream(objs[cid])
                if stream:
                    texts.append(_content_text(stream))
        pages.append("".join(texts).strip())
    if not pages:
        # no page tree found — fall back to every stream that looks like a
        # content stream, as one page
        chunks = []
        for _num, body in sorted(objs.items()):
            stream = _object_stream(body)
            if stream and (b"Tj" in stream or b"TJ" in stream):
                chunks.append(_content_text(stream))
        if not chunks:
            raise PdfError("no text content streams found")
        pages = ["".join(chunks).strip()]
    return pages


def pdf_extract_text(data: bytes) -> str:
    return "\n\n".join(pdf_extract_pages(data)).strip()


# ---------------------------------------------------------------------------
# DOCX / PPTX (Office Open XML zip packages)
# ---------------------------------------------------------------------------


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def docx_extract_text(data: bytes) -> str:
    """Paragraph text of a .docx (WordprocessingML) package."""
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        xml = zf.read("word/document.xml")
    root = ET.fromstring(xml)
    paragraphs: list[str] = []
    for p in root.iter():
        if _local(p.tag) != "p":
            continue
        runs: list[str] = []
        for node in p.iter():
            tag = _local(node.tag)
            if tag == "t" and node.text:
                runs.append(node.text)
            elif tag == "tab":
                runs.append("\t")
            elif tag == "br":
                runs.append("\n")
        if runs:
            paragraphs.append("".join(runs))
    return "\n".join(paragraphs)


def pptx_extract_slides(data: bytes) -> list[str]:
    """Per-slide text of a .pptx (PresentationML) package, slide order."""
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        slide_names = sorted(
            (n for n in zf.namelist() if re.fullmatch(r"ppt/slides/slide\d+\.xml", n)),
            key=lambda n: int(re.search(r"(\d+)\.xml$", n).group(1)),
        )
        slides: list[str] = []
        for name in slide_names:
            root = ET.fromstring(zf.read(name))
            texts = [
                node.text
                for node in root.iter()
                if _local(node.tag) == "t" and node.text
            ]
            slides.append("\n".join(texts))
    return slides


def pptx_extract_text(data: bytes) -> str:
    return "\n\n".join(pptx_extract_slides(data)).strip()

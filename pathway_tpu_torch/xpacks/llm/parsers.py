"""Document parsers (parity: xpacks/llm/parsers.py, 849 LoC).

Parsers are UDFs: ``bytes → tuple[(text, metadata)]``.  The family mirrors
the reference's — ``Utf8Parser``, ``UnstructuredParser`` (chunking modes +
post-processors), ``PypdfParser``, ``DoclingParser``, ``ImageParser``,
``SlideParser`` — but the PDF/DOCX/PPTX text paths are self-contained
stdlib extractors (``_doc_extract``) because none of the reference's
parsing dependencies ship in this image.  ``unstructured``/``docling``
are used when importable, exactly like the reference gates them.
"""

from __future__ import annotations

import json as _json
from typing import Any, Callable, Iterable, Literal, get_args

from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals.udfs import UDF
from pathway_tpu_torch.xpacks.llm import _doc_extract

ChunkingMode = Literal["single", "elements", "paged", "basic", "by_title"]


def _apply_post_processors(
    text: str, post_processors: Iterable[Callable[[str], str]] | None
) -> str:
    for proc in post_processors or ():
        text = proc(text)
    return text


def chunk_elements(
    elements: list[tuple[str, dict]],
    mode: ChunkingMode,
    *,
    max_characters: int = 500,
    new_after_n_chars: int | None = None,
) -> list[tuple[str, dict]]:
    """Chunk (text, metadata) elements the way the reference's
    UnstructuredParser does (parsers.py:174-230): ``single`` joins all,
    ``elements`` keeps one doc per element, ``paged`` groups by
    ``page_number``, ``by_title`` starts a chunk at each Title element,
    ``basic`` packs elements into ≤``max_characters`` chunks (soft break
    at ``new_after_n_chars``).

    Example:

    >>> from pathway_tpu_torch.xpacks.llm.parsers import chunk_elements
    >>> els = [
    ...     ("Intro", {"category": "Title", "page_number": 1}),
    ...     ("First paragraph.", {"page_number": 1}),
    ...     ("Methods", {"category": "Title", "page_number": 2}),
    ... ]
    >>> chunk_elements(els, "single")
    [('Intro\\n\\nFirst paragraph.\\n\\nMethods', {})]
    >>> [t for t, _m in chunk_elements(els, "by_title")]
    ['Intro\\nFirst paragraph.', 'Methods']
    >>> [m["page_number"] for _t, m in chunk_elements(els, "paged")]
    [1, 2]
    """
    if mode not in get_args(ChunkingMode):
        raise ValueError(
            f"Got {mode} for `chunking_mode`, but should be one of "
            f"`{get_args(ChunkingMode)}`"
        )
    if max_characters < 1:
        raise ValueError("`max_characters` must be a positive integer")
    if mode == "elements":
        return list(elements)
    if mode == "single":
        return [("\n\n".join(t for t, _m in elements), {})]
    if mode == "paged":
        pages: dict[Any, list[str]] = {}
        for text, meta in elements:
            pages.setdefault(meta.get("page_number"), []).append(text)
        return [
            ("\n".join(texts), {"page_number": page})
            for page, texts in sorted(
                pages.items(), key=lambda kv: (kv[0] is None, kv[0])
            )
        ]
    if mode == "by_title":
        chunks: list[list[tuple[str, dict]]] = []
        for text, meta in elements:
            if meta.get("category") == "Title" or not chunks:
                chunks.append([])
            chunks[-1].append((text, meta))
        return [
            ("\n".join(t for t, _m in chunk), dict(chunk[0][1]))
            for chunk in chunks
            if chunk
        ]
    # basic: pack into max_characters windows
    soft = new_after_n_chars or max_characters
    out: list[tuple[str, dict]] = []
    cur: list[str] = []
    cur_len = 0
    for text, _meta in elements:
        while len(text) > max_characters:  # oversized element: hard split
            if cur:
                out.append(("\n".join(cur), {}))
                cur, cur_len = [], 0
            out.append((text[:max_characters], {}))
            text = text[max_characters:]
        add = len(text) + (1 if cur else 0)
        if cur and (cur_len + add > max_characters or cur_len >= soft):
            out.append(("\n".join(cur), {}))
            cur, cur_len = [], 0
        cur.append(text)
        cur_len += add
    if cur:
        out.append(("\n".join(cur), {}))
    return out


class Utf8Parser(UDF):
    """Decode bytes to one text document (parity: parsers.py Utf8Parser)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

        def parse(contents: bytes) -> tuple:
            if isinstance(contents, bytes):
                text = contents.decode("utf-8", errors="replace")
            else:
                text = str(contents)
            return ((text, Json({})),)

        self.__wrapped__ = parse


# reference alias (deprecated name there)
ParseUtf8 = Utf8Parser


class UnstructuredParser(UDF):
    """unstructured-io parser with the reference's chunking modes and
    post-processors (parity: parsers.py UnstructuredParser:82-317).
    Gated on the ``unstructured`` package."""

    def __init__(
        self,
        chunking_mode: ChunkingMode = "single",
        post_processors: list[Callable[[str], str]] | None = None,
        chunking_kwargs: dict | None = None,
        mode: str | None = None,  # deprecated alias for chunking_mode
        **unstructured_kwargs,
    ):
        super().__init__()
        if mode is not None:
            chunking_mode = mode  # type: ignore[assignment]
        if chunking_mode not in get_args(ChunkingMode):
            raise ValueError(
                f"Got {chunking_mode} for `chunking_mode`, but should be "
                f"one of `{get_args(ChunkingMode)}`"
            )
        self.chunking_mode: ChunkingMode = chunking_mode
        self.post_processors = list(post_processors or [])
        self.chunking_kwargs = dict(chunking_kwargs or {})
        self.kwargs = dict(unstructured_kwargs)

        def parse(contents: bytes) -> tuple:
            import io

            from unstructured.partition.auto import partition  # gated

            elements = partition(file=io.BytesIO(contents), **self.kwargs)
            pairs = []
            for e in elements:
                meta = e.metadata.to_dict() if hasattr(e, "metadata") else {}
                if hasattr(e, "category"):
                    meta["category"] = e.category
                text = _apply_post_processors(str(e), self.post_processors)
                pairs.append((text, meta))
            chunks = chunk_elements(
                pairs, self.chunking_mode, **self.chunking_kwargs
            )
            return tuple((text, Json(meta)) for text, meta in chunks)

        self.__wrapped__ = parse


ParseUnstructured = UnstructuredParser


class ParseJson(UDF):
    """Parse a JSON document into (text, metadata) using a text field."""

    def __init__(self, text_field: str = "text", **kwargs):
        super().__init__(**kwargs)

        def parse(contents: bytes) -> tuple:
            obj = _json.loads(
                contents.decode("utf-8", errors="replace")
                if isinstance(contents, bytes)
                else str(contents)
            )
            text = obj.pop(text_field, "")
            return ((str(text), Json(obj)),)

        self.__wrapped__ = parse


class PypdfParser(UDF):
    """PDF → text (parity: parsers.py PypdfParser:775).

    Uses ``pypdf`` when importable; otherwise the stdlib extractor
    (``_doc_extract.pdf_extract_pages``) — FlateDecode content streams,
    text operators, page-tree page order.  ``chunking_mode``: ``single``
    (whole document) or ``paged`` (one doc per page with page_number).
    """

    def __init__(
        self,
        chunking_mode: Literal["single", "paged"] = "single",
        apply_text_cleanup: bool = True,
        post_processors: list[Callable[[str], str]] | None = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if chunking_mode not in ("single", "paged"):
            raise ValueError(
                f"Got {chunking_mode} for `chunking_mode`, "
                "but should be `single` or `paged`"
            )
        self.chunking_mode = chunking_mode
        self.apply_text_cleanup = apply_text_cleanup
        self.post_processors = list(post_processors or [])

        def parse(contents: bytes) -> tuple:
            pages = self._extract_pages(contents)
            if self.apply_text_cleanup:
                pages = [self._cleanup(p) for p in pages]
            pages = [
                _apply_post_processors(p, self.post_processors) for p in pages
            ]
            if self.chunking_mode == "paged":
                return tuple(
                    (text, Json({"page_number": i + 1}))
                    for i, text in enumerate(pages)
                )
            return (("\n\n".join(pages).strip(), Json({})),)

        self.__wrapped__ = parse

    @staticmethod
    def _extract_pages(contents: bytes) -> list[str]:
        try:
            import io

            from pypdf import PdfReader  # optional, like the reference

            reader = PdfReader(io.BytesIO(contents))
            return [page.extract_text() or "" for page in reader.pages]
        except ImportError:
            return _doc_extract.pdf_extract_pages(contents)

    @staticmethod
    def _cleanup(text: str) -> str:
        """Join hyphenated line breaks, collapse whitespace runs, drop
        empty lines (the reference's text cleanup switches)."""
        import re

        text = re.sub(r"-\n(\w)", r"\1", text)  # de-hyphenate across lines
        text = re.sub(r"[ \t]+", " ", text)
        lines = [ln.strip() for ln in text.splitlines()]
        return "\n".join(ln for ln in lines if ln)


class DocxParser(UDF):
    """DOCX → text via the stdlib WordprocessingML extractor."""

    def __init__(
        self,
        post_processors: list[Callable[[str], str]] | None = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.post_processors = list(post_processors or [])

        def parse(contents: bytes) -> tuple:
            text = _doc_extract.docx_extract_text(contents)
            text = _apply_post_processors(text, self.post_processors)
            return ((text, Json({})),)

        self.__wrapped__ = parse


class PptxParser(UDF):
    """PPTX → per-slide text via the stdlib PresentationML extractor.

    ``chunking_mode``: ``single`` (whole deck) or ``paged`` (one doc per
    slide, with ``slide_number`` metadata) — the text backbone of
    SlideParser/SlidesDocumentStore.
    """

    def __init__(
        self,
        chunking_mode: Literal["single", "paged"] = "paged",
        post_processors: list[Callable[[str], str]] | None = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if chunking_mode not in ("single", "paged"):
            raise ValueError(
                f"Got {chunking_mode} for `chunking_mode`, "
                "but should be `single` or `paged`"
            )
        self.chunking_mode = chunking_mode
        self.post_processors = list(post_processors or [])

        def parse(contents: bytes) -> tuple:
            slides = _doc_extract.pptx_extract_slides(contents)
            slides = [
                _apply_post_processors(s, self.post_processors) for s in slides
            ]
            if self.chunking_mode == "paged":
                return tuple(
                    (text, Json({"slide_number": i + 1}))
                    for i, text in enumerate(slides)
                )
            return (("\n\n".join(slides).strip(), Json({})),)

        self.__wrapped__ = parse


class ImageParser(UDF):
    """Image → description via a vision LLM (parity: parsers.py
    ImageParser:456).  Takes any chat UDF whose callable accepts an
    OpenAI-style message list (content parts with an ``image_url`` data
    URL)."""

    def __init__(
        self,
        llm: Any,
        parse_prompt: str = "Describe the image contents concisely.",
        downsize_horizontal_width: int | None = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.llm = llm
        self.parse_prompt = parse_prompt
        self.downsize_horizontal_width = downsize_horizontal_width

        def parse(contents: bytes) -> tuple:
            import base64

            data = contents
            if self.downsize_horizontal_width:
                data = _downsize_image(data, self.downsize_horizontal_width)
            b64 = base64.b64encode(data).decode()
            mime = _sniff_image_mime(data)
            messages = [
                {
                    "role": "user",
                    "content": [
                        {"type": "text", "text": self.parse_prompt},
                        {
                            "type": "image_url",
                            "image_url": {
                                "url": f"data:{mime};base64,{b64}"
                            },
                        },
                    ],
                }
            ]
            text = self.llm.__wrapped__(messages)
            return ((str(text), Json({})),)

        self.__wrapped__ = parse


def _sniff_image_mime(data: bytes) -> str:
    """Media type from magic bytes — vision APIs reject a mislabeled
    payload (e.g. a JPEG claiming image/png)."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "image/png"
    if data[:2] == b"\xff\xd8":
        return "image/jpeg"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "image/gif"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "image/webp"
    return "image/png"


def _downsize_image(data: bytes, width: int) -> bytes:
    try:
        import io

        from PIL import Image

        img = Image.open(io.BytesIO(data))
        if img.width > width:
            img = img.resize((width, int(img.height * width / img.width)))
        out = io.BytesIO()
        img.save(out, format="PNG")
        return out.getvalue()
    except ImportError:
        return data


class SlideParser(UDF):
    """PPTX/PDF slides → text, optionally enriched by a vision LLM
    (parity: parsers.py SlideParser:598 — there each slide is rendered to
    an image for a vision model; here the text backbone is the stdlib
    extractor and the LLM enrichment is optional, since no slide
    rasterizer ships in this image)."""

    def __init__(
        self,
        llm: Any | None = None,
        parse_prompt: str = "Describe this slide concisely.",
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.llm = llm
        self.parse_prompt = parse_prompt

        def parse(contents: bytes) -> tuple:
            if contents[:4] == b"%PDF":
                texts = _doc_extract.pdf_extract_pages(contents)
                unit = "page_number"
            else:
                texts = _doc_extract.pptx_extract_slides(contents)
                unit = "slide_number"
            out = []
            for i, text in enumerate(texts):
                if self.llm is not None:
                    enriched = self.llm.__wrapped__(
                        [
                            {
                                "role": "user",
                                "content": f"{self.parse_prompt}\n\n{text}",
                            }
                        ]
                    )
                    text = str(enriched)
                out.append((text, Json({unit: i + 1})))
            return tuple(out)

        self.__wrapped__ = parse


class DoclingParser(UDF):
    """docling-based PDF→markdown parser (parity: parsers.py
    DoclingParser:329).  Gated on the ``docling`` package; falls back to
    the stdlib PDF extractor so the class stays usable in this image."""

    def __init__(self, chunk: bool = True, **kwargs):
        super().__init__()
        self.chunk = chunk
        self.kwargs = kwargs

        def parse(contents: bytes) -> tuple:
            try:
                return self._parse_docling(contents)
            except ImportError:
                pages = _doc_extract.pdf_extract_pages(contents)
                if self.chunk:
                    return tuple(
                        (text, Json({"page_number": i + 1}))
                        for i, text in enumerate(pages)
                    )
                return (("\n\n".join(pages).strip(), Json({})),)

        self.__wrapped__ = parse

    def _parse_docling(self, contents: bytes) -> tuple:
        import io

        from docling.document_converter import DocumentConverter  # gated

        converter = DocumentConverter(**self.kwargs)
        result = converter.convert(io.BytesIO(contents))
        md = result.document.export_to_markdown()
        return ((md, Json({})),)

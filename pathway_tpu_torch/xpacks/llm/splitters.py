"""Text splitters (parity: xpacks/llm/splitters.py).

``TokenCountSplitter`` — token-budgeted chunks with soft boundaries;
``RecursiveSplitter`` — separator-hierarchy splitting (langchain-style, as
the reference wraps); ``NullSplitter`` — identity.
Splitters are UDFs returning tuple[(text, metadata)] chunks.
"""

from __future__ import annotations

import re
from typing import Any

from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals.udfs import UDF


def null_splitter(txt: str) -> list[tuple[str, dict]]:
    """One chunk, the full text, empty metadata (reference splitters.py:13)."""
    return [(txt, {})]


def _to_text(data: Any) -> str:
    if isinstance(data, bytes):
        return data.decode("utf-8", errors="replace")
    if isinstance(data, Json):
        return str(data.value)
    return str(data)


class BaseSplitter(UDF):
    def chunk(self, text: str, metadata: dict | None = None) -> list[tuple[str, dict]]:
        raise NotImplementedError

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

        def split(text, metadata=None) -> tuple:
            meta = metadata.value if isinstance(metadata, Json) else (metadata or {})
            chunks = self.chunk(_to_text(text), dict(meta))
            return tuple((c, Json(m)) for (c, m) in chunks)

        self.__wrapped__ = split


class NullSplitter(BaseSplitter):
    """Identity splitter (parity: splitters.py NullSplitter)."""

    def chunk(self, text: str, metadata: dict | None = None) -> list[tuple[str, dict]]:
        return [(text, metadata or {})]


_WORDS = re.compile(r"\S+")


class TokenCountSplitter(BaseSplitter):
    """Split into chunks of [min_tokens, max_tokens] tokens, preferring to
    break at sentence/punctuation boundaries (parity: splitters.py
    TokenCountSplitter, tiktoken-based in the reference; token = whitespace
    word here unless a local HF tokenizer is available).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter
    >>> split = TokenCountSplitter(min_tokens=2, max_tokens=3)
    >>> chunks = split.__wrapped__('one two three four five')
    >>> print([c[0] for c in chunks])
    ['one two three', 'four five']
    """

    def __init__(
        self,
        min_tokens: int = 50,
        max_tokens: int = 500,
        encoding_name: str = "cl100k_base",
        **kwargs,
    ):
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens
        self.encoding_name = encoding_name
        super().__init__(**kwargs)

    def chunk(self, text: str, metadata: dict | None = None) -> list[tuple[str, dict]]:
        metadata = metadata or {}
        words = _WORDS.findall(text)
        if not words:
            return []
        chunks: list[tuple[str, dict]] = []
        start = 0
        while start < len(words):
            end = min(start + self.max_tokens, len(words))
            # prefer a sentence boundary after min_tokens
            best = end
            if end < len(words):
                for j in range(end, max(start + self.min_tokens, start + 1) - 1, -1):
                    if words[j - 1].endswith((".", "!", "?", ";", ":")):
                        best = j
                        break
            chunk_words = words[start:best]
            chunks.append((" ".join(chunk_words), dict(metadata)))
            start = best
        return chunks


class RecursiveSplitter(BaseSplitter):
    """Recursive separator splitting with overlap (parity: splitters.py
    RecursiveSplitter wrapping langchain's RecursiveCharacterTextSplitter)."""

    def __init__(
        self,
        chunk_size: int = 500,
        chunk_overlap: int = 0,
        separators: list[str] | None = None,
        encoding_name: str = "cl100k_base",
        model_name: str | None = None,
        **kwargs,
    ):
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        if chunk_overlap < 0 or chunk_overlap >= chunk_size:
            raise ValueError(
                f"chunk_overlap ({chunk_overlap}) must be in [0, chunk_size)"
                f" — chunk_size is {chunk_size}"
            )
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.separators = separators or ["\n\n", "\n", ". ", " ", ""]
        super().__init__(**kwargs)

    def _split_rec(self, text: str, seps: list[str]) -> list[str]:
        if len(text) <= self.chunk_size:
            return [text] if text else []
        if not seps:
            return [
                text[i : i + self.chunk_size]
                for i in range(0, len(text), self.chunk_size - self.chunk_overlap or self.chunk_size)
            ]
        sep, rest = seps[0], seps[1:]
        if sep == "":
            return self._split_rec(text, rest) if rest else self._split_rec(text, [])
        parts = text.split(sep)
        chunks, cur = [], ""
        for part in parts:
            candidate = (cur + sep + part) if cur else part
            if len(candidate) <= self.chunk_size:
                cur = candidate
            else:
                if cur:
                    chunks.append(cur)
                if len(part) > self.chunk_size:
                    chunks.extend(self._split_rec(part, rest))
                    cur = ""
                else:
                    cur = part
        if cur:
            chunks.append(cur)
        if self.chunk_overlap and len(chunks) > 1:
            overlapped = [chunks[0]]
            for prev, nxt in zip(chunks, chunks[1:]):
                tail = prev[-self.chunk_overlap :]
                overlapped.append(tail + sep + nxt if tail else nxt)
            chunks = overlapped
        return chunks

    def chunk(self, text: str, metadata: dict | None = None) -> list[tuple[str, dict]]:
        return [(c, dict(metadata or {})) for c in self._split_rec(text, self.separators)]

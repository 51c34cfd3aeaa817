"""Frozen copies of the text rules the port applies before the device.

``hash_ids`` is the hash tokenizer the port uses when no WordPiece
vocabulary is cached (words and punctuation hashed with BLAKE2b into the
vocabulary above the BERT special ids), ``decode`` its placeholder
decoding, and ``split_chunks`` the ``TokenCountSplitter`` rule: whitespace
words, at most ``max_tokens`` a chunk, cut after the last word ending a
sentence once ``min_tokens`` are in.
"""

from __future__ import annotations

import hashlib
import re

WORD = re.compile(r"\w+|[^\w\s]")
SPACE_WORD = re.compile(r"\S+")
CLS, SEP, PAD = 101, 102, 0
FIRST_ID = 104  # ids below are BERT's special and unused ids
SENTENCE_ENDS = (".", "!", "?", ";", ":")


def hash_ids(text: str, vocab_size: int, max_length: int) -> list[int]:
    """``[CLS] token ids [SEP]`` of ``text``, at most ``max_length`` ids."""
    ids = [CLS]
    for tok in WORD.findall(text)[: max_length - 2]:
        digest = hashlib.blake2b(tok.lower().encode(), digest_size=4).digest()
        ids.append(FIRST_ID + int.from_bytes(digest, "little") % (vocab_size - FIRST_ID))
    ids.append(SEP)
    return ids


def decode(ids) -> str:
    """The hash tokenizer's text for generated ids: one placeholder a token."""
    return " ".join(f"tok{int(i)}" for i in ids if int(i) not in (CLS, SEP, PAD))


def split_chunks(text: str, min_tokens: int, max_tokens: int) -> list[str]:
    """The chunks of ``text`` under the token-count rule."""
    words = SPACE_WORD.findall(text)
    chunks, start = [], 0
    while start < len(words):
        end = min(start + max_tokens, len(words))
        cut = end
        if end < len(words):
            for j in range(end, max(start + min_tokens, start + 1) - 1, -1):
                if words[j - 1].endswith(SENTENCE_ENDS):
                    cut = j
                    break
        chunks.append(" ".join(words[start:cut]))
        start = cut
    return chunks

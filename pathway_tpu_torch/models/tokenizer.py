"""Tokenizers for the port's encoder models.

Counterpart of ``pathway_tpu/models/tokenizer.py``, copied so that the
port imports nothing of the JAX package; token ids, padding and sequence
buckets are identical to the JAX package's.

When a HuggingFace tokenizer for the requested model is present in the local
cache it is used (exact MiniLM/BGE WordPiece); otherwise a deterministic
hashing tokenizer stands in — same vocab size and sequence statistics, so
device-side shapes, padding buckets, and FLOPs match the real model.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any

import numpy as np

_WORD = re.compile(r"\w+|[^\w\s]")

CLS_ID = 101
SEP_ID = 102
PAD_ID = 0


class HashTokenizer:
    """Deterministic whitespace+punct tokenizer hashing tokens into the vocab."""

    def __init__(self, vocab_size: int = 30522, max_length: int = 512):
        self.vocab_size = vocab_size
        self.max_length = max_length

    def encode(self, text: str, max_length: int | None = None) -> list[int]:
        max_length = max_length or self.max_length
        toks = _WORD.findall(text or "")[: max_length - 2]
        ids = [CLS_ID]
        for t in toks:
            h = int.from_bytes(
                hashlib.blake2b(t.lower().encode(), digest_size=4).digest(), "little"
            )
            # avoid special ids 0..103 (BERT special/unused range)
            ids.append(104 + h % (self.vocab_size - 104))
        ids.append(SEP_ID)
        return ids

    def encode_pair(self, a: str, b: str, max_length: int | None = None) -> list[int]:
        max_length = max_length or self.max_length
        ia = self.encode(a)[:-1]
        ib = self.encode(b)[1:]
        ids = (ia + [SEP_ID] + ib)[:max_length]
        if ids[-1] != SEP_ID:
            ids[-1] = SEP_ID
        return ids

    def decode(self, ids: list[int]) -> str:
        """Hashing is one-way; emit stable placeholders (shape-true text)."""
        return " ".join(f"tok{int(i)}" for i in ids if i not in (CLS_ID, SEP_ID, PAD_ID))


def load_tokenizer(model_name: str, vocab_size: int, max_length: int) -> Any:
    """HF tokenizer if ``model_name`` is a local checkpoint directory or is
    present in the local HF cache; else the hashing stand-in."""
    import os

    cache = os.path.expanduser(
        os.environ.get("HF_HOME", "~/.cache/huggingface")
    )
    if not os.path.isdir(cache) and not os.path.isdir(model_name):
        # no local model cache: skip the (slow) transformers import entirely
        return HashTokenizer(vocab_size=vocab_size, max_length=max_length)
    try:
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
        from transformers import AutoTokenizer

        hf = AutoTokenizer.from_pretrained(model_name)

        class _HFAdapter:
            vocab_size = hf.vocab_size

            def encode(self, text, max_length=max_length):
                return hf.encode(text, truncation=True, max_length=max_length)

            def encode_pair(self, a, b, max_length=max_length):
                return hf.encode(a, b, truncation=True, max_length=max_length)

            def decode(self, ids):
                return hf.decode(ids, skip_special_tokens=True)

        return _HFAdapter()
    except Exception:
        return HashTokenizer(vocab_size=vocab_size, max_length=max_length)


def pad_batch(
    id_lists: list[list[int]], seq_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of token id lists to [batch, seq_len] + attention mask."""
    batch = len(id_lists)
    ids = np.full((batch, seq_len), PAD_ID, dtype=np.int32)
    mask = np.zeros((batch, seq_len), dtype=np.int32)
    for i, lst in enumerate(id_lists):
        lst = lst[:seq_len]
        ids[i, : len(lst)] = lst
        mask[i, : len(lst)] = 1
    return ids, mask


def bucket_seq_len(n: int, buckets=(16, 32, 64, 128, 256, 512)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def bucket_batch(n: int, max_batch: int = 256) -> int:
    p = 1
    while p < n:
        p <<= 1
    return min(p, max_batch)

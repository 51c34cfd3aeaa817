"""BM25 full-text index (parity: stdlib/indexing/bm25.py:41 +
src/external_integration/tantivy_integration.rs).

A copy of ``pathway_tpu/stdlib/indexing/bm25.py``: a host-side inverted
index with incremental add/remove and Okapi BM25 scoring, the role tantivy
plays in the reference.  Text scoring is sparse and integer-heavy, so it
stays on the host; hybrid fusion combines it with a dense index.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Any

from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.stdlib.indexing.data_index import InnerIndex
from pathway_tpu_torch.stdlib.indexing.filters import metadata_matches

_WORD = re.compile(r"\w+")


def _tokenize(text: str) -> list[str]:
    return [w.lower() for w in _WORD.findall(text or "")]


class BM25Index:
    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1 = k1
        self.b = b
        self._docs: dict[int, Counter] = {}
        self._doc_len: dict[int, int] = {}
        self._filters: dict[int, Any] = {}
        self._postings: dict[str, set[int]] = defaultdict(set)
        self._total_len = 0

    def add(self, key: int, text, filter_data=None) -> None:
        tokens = Counter(_tokenize(text if isinstance(text, str) else str(text)))
        self._docs[key] = tokens
        n = sum(tokens.values())
        self._doc_len[key] = n
        self._total_len += n
        if filter_data is not None:
            self._filters[key] = filter_data
        for t in tokens:
            self._postings[t].add(key)

    def remove(self, key: int) -> None:
        tokens = self._docs.pop(key, None)
        if tokens is None:
            return
        self._total_len -= self._doc_len.pop(key, 0)
        self._filters.pop(key, None)
        for t in tokens:
            s = self._postings.get(t)
            if s:
                s.discard(key)
                if not s:
                    del self._postings[t]

    def search(self, query, k: int | None, filter_query=None) -> list[tuple[int, float]]:
        if k is None:
            k = 3
        q_tokens = _tokenize(query if isinstance(query, str) else str(query))
        n_docs = len(self._docs)
        if n_docs == 0 or not q_tokens:
            return []
        avgdl = self._total_len / n_docs
        scores: Counter = Counter()
        for t in q_tokens:
            postings = self._postings.get(t)
            if not postings:
                continue
            idf = math.log(1 + (n_docs - len(postings) + 0.5) / (len(postings) + 0.5))
            for key in postings:
                tf = self._docs[key][t]
                dl = self._doc_len[key]
                denom = tf + self.k1 * (1 - self.b + self.b * dl / avgdl)
                scores[key] += idf * tf * (self.k1 + 1) / denom
        out = []
        for key, score in scores.most_common():
            if filter_query is not None and not metadata_matches(
                filter_query, self._filters.get(key)
            ):
                continue
            out.append((key, float(score)))
            if len(out) >= k:
                break
        return out


class TantivyBM25(InnerIndex):
    """BM25 inner index (API parity with stdlib/indexing/bm25.py:41)."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnReference | None = None,
        *,
        ram_budget: int = 50_000_000,
        in_memory_index: bool = True,
    ):
        super().__init__(data_column, metadata_column)

    def factory(self):
        class _F:
            @staticmethod
            def build():
                return BM25Index()

        return _F()


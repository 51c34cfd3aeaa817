"""Rerankers (parity: xpacks/llm/rerankers.py:58-322).

A copy of ``pathway_tpu/xpacks/llm/rerankers.py``.  ``CrossEncoderReranker``
scores (query, doc) pairs with the port's cross-encoder
(``models/encoder.py``, whose attention is the hand-written encoder
kernel on the card) through the async micro-batcher, on the default
executor of the model's device.  ``LLMReranker`` asks a chat model for a 1-5 score;
``EncoderReranker`` scores by bi-encoder cosine; ``rerank_topk_filter``
mirrors the reference helper.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

from pathway_tpu_torch.device import get_default_executor
from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ApplyExpression, ColumnExpression
from pathway_tpu_torch.internals.udfs import UDF, async_executor
from pathway_tpu_torch.utils.batching import AsyncMicroBatcher


class CrossEncoderReranker(UDF):
    """Cross-encoder scoring (parity: rerankers.py CrossEncoderReranker).

    ``device`` is the port's own: the model runs on ``cuda:0`` unless it
    names another device."""

    def __init__(
        self,
        model_name: str = "cross-encoder/ms-marco-MiniLM-L-6-v2",
        *,
        max_batch_size: int = 256,
        cache_strategy=None,
        device=None,
        **init_kwargs,
    ):
        super().__init__(executor=async_executor(), deterministic=True, cache_strategy=cache_strategy)
        from pathway_tpu_torch.models.encoder import shared_cross_encoder

        self._ce = shared_cross_encoder(model_name, device=device)
        self._batcher = AsyncMicroBatcher(
            self._process,
            max_batch_size=max_batch_size,
            executor=get_default_executor(self._ce.device),
            name=f"reranker:{model_name}",
        )

        async def rerank(doc: str, query: str) -> float:
            return await self._batcher.submit((query or "", _doc_text(doc)))

        self.__wrapped__ = rerank

    def _process(self, pairs: list[tuple[str, str]]) -> list[float]:
        return [float(s) for s in self._ce.score(pairs)]


class EncoderReranker(UDF):
    """Bi-encoder cosine rerank (parity: rerankers.py EncoderReranker)."""

    def __init__(self, embedder=None, model_name: str = "all-MiniLM-L6-v2", device=None, **kwargs):
        super().__init__(executor=async_executor(), deterministic=True)
        from pathway_tpu_torch.models.encoder import shared_sentence_encoder

        self._enc = shared_sentence_encoder(model_name, device=device)
        self._batcher = AsyncMicroBatcher(self._process, executor=get_default_executor(self._enc.device))

        async def rerank(doc: str, query: str) -> float:
            return await self._batcher.submit((query or "", _doc_text(doc)))

        self.__wrapped__ = rerank

    def _process(self, pairs: list[tuple[str, str]]) -> list[float]:
        texts = [t for pair in pairs for t in pair]
        vecs = self._enc.encode(texts)
        out = []
        for i in range(len(pairs)):
            q, d = vecs[2 * i], vecs[2 * i + 1]
            out.append(float(q @ d))
        return out


class LLMReranker(UDF):
    """Chat-based 1-5 relevance scoring (parity: rerankers.py LLMReranker)."""

    def __init__(self, llm, *, retry_strategy=None, cache_strategy=None, **kwargs):
        super().__init__(
            executor=async_executor(retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )
        self.llm = llm

        async def rerank(doc: str, query: str) -> float:
            prompt = (
                "Given a query and a document, rate on a scale from 1 to 5 how "
                "relevant the document is to the query. Respond with only the "
                f"number.\nQuery: {query}\nDocument: {_doc_text(doc)}\nScore:"
            )
            # keeps the LLM UDF's retry/capacity/cache config applied
            res = await self.llm.as_async_callable()(
                [{"role": "user", "content": prompt}]
            )
            m = re.search(r"[1-5]", str(res) or "")
            if not m:
                raise ValueError(f"reranker LLM returned no score: {res!r}")
            return float(m.group(0))

        self.__wrapped__ = rerank


class FlashRankReranker(UDF):
    """FlashRank reranker (parity: rerankers.py). Gated on `flashrank`."""

    def __init__(self, model: str = "ms-marco-TinyBERT-L-2-v2", **kwargs):
        super().__init__(executor=async_executor())
        self.model = model
        self._ranker = None

        async def rerank(doc: str, query: str) -> float:
            from flashrank import RerankRequest  # gated

            if self._ranker is None:
                from flashrank import Ranker

                self._ranker = Ranker(model_name=self.model)
            req = RerankRequest(query=query, passages=[{"text": _doc_text(doc)}])
            return float(self._ranker.rerank(req)[0]["score"])

        self.__wrapped__ = rerank


def _doc_text(doc: Any) -> str:
    if isinstance(doc, Json):
        doc = doc.value
    if isinstance(doc, dict):
        return str(doc.get("text", doc))
    return str(doc)


def rerank_topk_filter(
    docs: ColumnExpression, scores: ColumnExpression, k: int = 5
) -> ColumnExpression:
    """Keep the k best (docs, scores) pairs (parity: rerankers.py:58)."""

    def topk(docs_v, scores_v):
        order = np.argsort(-np.asarray(scores_v, dtype=float))[:k]
        return (
            tuple(docs_v[i] for i in order),
            tuple(float(scores_v[i]) for i in order),
        )

    return ApplyExpression(topk, None, docs, scores)

"""LLM/RAG xpack (parity: python/pathway/xpacks/llm/, 8k LoC).

The port of ``pathway_tpu/xpacks/llm``: embedders and rerankers over the
port's encoders and ``AsyncMicroBatcher``, ``JaxChat`` over the port's
decoder and generation scheduler, parsers, splitters, prompts, the
``DocumentStore``, ``VectorStoreServer`` over the device index, the
question answerers, and REST servers on ``pw.io.http``.
"""

from pathway_tpu_torch.xpacks.llm import (
    embedders,
    llms,
    mocks,
    parsers,
    prompts,
    rerankers,
    servers,
    splitters,
)
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore, SlidesDocumentStore
from pathway_tpu_torch.xpacks.llm.question_answering import (
    AdaptiveRAGQuestionAnswerer,
    BaseContextProcessor,
    BaseRAGQuestionAnswerer,
    DeckRetriever,
    RAGClient,
    SimpleContextProcessor,
    SummaryQuestionAnswerer,
    send_post_request,
)
from pathway_tpu_torch.xpacks.llm.vector_store import (
    SlidesVectorStoreServer,
    VectorStoreClient,
    VectorStoreServer,
)

__all__ = [
    "embedders",
    "llms",
    "mocks",
    "parsers",
    "prompts",
    "rerankers",
    "servers",
    "splitters",
    "DocumentStore",
    "SlidesDocumentStore",
    "AdaptiveRAGQuestionAnswerer",
    "BaseContextProcessor",
    "BaseRAGQuestionAnswerer",
    "DeckRetriever",
    "RAGClient",
    "SimpleContextProcessor",
    "SummaryQuestionAnswerer",
    "send_post_request",
    "SlidesVectorStoreServer",
    "VectorStoreClient",
    "VectorStoreServer",
]

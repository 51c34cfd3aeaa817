"""LLM/RAG xpack (parity: python/pathway/xpacks/llm/, 8k LoC).

The retrieval half of ``pathway_tpu/xpacks/llm``: embedders over the
port's encoders and ``AsyncMicroBatcher``, parsers, splitters, the
``DocumentStore`` and ``VectorStoreServer`` over the device index.  The
answering half comes later and its modules raise ``NotImplementedError``
on use, naming the slice: ``servers`` (with ``run_server`` and
``VectorStoreClient``) the REST slice; ``llms``, ``rerankers``,
``prompts`` and ``question_answering`` the answering slice.
"""

from pathway_tpu_torch.io import _LaterSlice
from pathway_tpu_torch.xpacks.llm import embedders, mocks, parsers, splitters
from pathway_tpu_torch.xpacks.llm._utils import send_post_request
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore, SlidesDocumentStore
from pathway_tpu_torch.xpacks.llm.vector_store import (
    SlidesVectorStoreServer,
    VectorStoreClient,
    VectorStoreServer,
)

servers = _LaterSlice(f"{__name__}.servers", "the REST slice (with io/http/)")
llms = _LaterSlice(f"{__name__}.llms", "the answering slice")
rerankers = _LaterSlice(f"{__name__}.rerankers", "the answering slice")
prompts = _LaterSlice(f"{__name__}.prompts", "the answering slice")
question_answering = _LaterSlice(f"{__name__}.question_answering", "the answering slice")

__all__ = [
    "embedders",
    "llms",
    "mocks",
    "parsers",
    "prompts",
    "rerankers",
    "servers",
    "splitters",
    "question_answering",
    "DocumentStore",
    "SlidesDocumentStore",
    "send_post_request",
    "SlidesVectorStoreServer",
    "VectorStoreClient",
    "VectorStoreServer",
]

"""Index abstractions for retrieval (parity: stdlib/indexing/).

``DataIndex`` + inner indexes: ``BruteForceKnn`` (the device top-k of
``ops/topk.py``), ``USearchKnn`` (an HNSW graph on the host), ``TantivyBM25``
(host BM25), ``HybridIndex`` (reciprocal-rank fusion) and ``LshKnn``;
retriever factories for DocumentStore wiring.
"""

from pathway_tpu_torch.stdlib.indexing.full_text_document_index import (
    default_full_text_document_index,
)
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    BruteForceKnnIndex,
    DistanceMetric,
    LshKnn,
    USearchKnn,
)
from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25
from pathway_tpu_torch.stdlib.indexing.hybrid_index import HybridDataIndex, HybridIndex
from pathway_tpu_torch.stdlib.indexing.vector_document_index import (
    default_brute_force_knn_document_index,
    default_lsh_knn_document_index,
    default_usearch_knn_document_index,
    default_vector_document_index,
)
from pathway_tpu_torch.stdlib.indexing.retrievers import (
    AbstractRetrieverFactory,
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    HybridIndexFactory,
    TantivyBM25Factory,
    USearchMetricKind,
    UsearchKnnFactory,
    LshKnnFactory,
)

__all__ = [
    "DataIndex",
    "InnerIndex",
    "BruteForceKnn",
    "BruteForceKnnIndex",
    "LshKnn",
    "USearchKnn",
    "DistanceMetric",
    "TantivyBM25",
    "HybridIndex",
    "HybridDataIndex",
    "default_full_text_document_index",
    "default_vector_document_index",
    "default_brute_force_knn_document_index",
    "default_lsh_knn_document_index",
    "default_usearch_knn_document_index",
    "AbstractRetrieverFactory",
    "BruteForceKnnFactory",
    "BruteForceKnnMetricKind",
    "HybridIndexFactory",
    "LshKnnFactory",
    "TantivyBM25Factory",
    "USearchMetricKind",
    "UsearchKnnFactory",
]

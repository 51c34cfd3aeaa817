"""Index abstractions for retrieval (parity: stdlib/indexing/).

``DataIndex`` + inner indexes: ``BruteForceKnn`` (the device top-k of
``ops/topk.py``) and ``LshKnn``; retriever factories for DocumentStore
wiring.  USearch's HNSW, BM25, the hybrid index and the full-text
document index come with the index slice of the port: their names here
raise ``NotImplementedError`` when called.
"""

from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    BruteForceKnnIndex,
    DistanceMetric,
    LshKnn,
    USearchKnn,
)
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
    index_slice_error,
)


def _index_slice(name: str, module: str):
    def later(*args, **kwargs):
        raise index_slice_error(name, module)

    later.__name__ = name
    return later


TantivyBM25 = _index_slice("TantivyBM25", "bm25.py")
HybridIndex = _index_slice("HybridIndex", "hybrid_index.py")
HybridDataIndex = _index_slice("HybridDataIndex", "hybrid_index.py")
default_full_text_document_index = _index_slice(
    "default_full_text_document_index", "full_text_document_index.py"
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

"""Document-index factory helpers (parity:
stdlib/indexing/vector_document_index.py:34-157).

A copy of ``pathway_tpu/stdlib/indexing/vector_document_index.py``.  The
default index is USearch's HNSW on the host, as in the JAX package;
``device`` of the brute-force index is the port's own.
"""

from __future__ import annotations

from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    DistanceMetric,
    LshKnn,
    USearchKnn,
)


def default_vector_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    embedder=None,
    dimensions: int | None = None,
    metadata_column: ColumnReference | None = None,
) -> DataIndex:
    return default_usearch_knn_document_index(
        data_column,
        data_table,
        embedder=embedder,
        dimensions=dimensions,
        metadata_column=metadata_column,
    )


def default_usearch_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    embedder=None,
    dimensions: int | None = None,
    metadata_column: ColumnReference | None = None,
) -> DataIndex:
    inner = USearchKnn(
        data_column,
        metadata_column,
        dimensions=dimensions,
        metric=DistanceMetric.COS,
        embedder=embedder,
    )
    return DataIndex(data_table, inner)


def default_brute_force_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    embedder=None,
    dimensions: int | None = None,
    metadata_column: ColumnReference | None = None,
    device=None,
) -> DataIndex:
    r"""Dense KNN document index over the device top-k path (on ``cuda:0``
    unless ``device`` names another device).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> from pathway_tpu_torch.stdlib.indexing import default_brute_force_knn_document_index
    >>> from pathway_tpu_torch.xpacks.llm.mocks import FakeEmbeddings
    >>> docs = pw.debug.table_from_markdown('''
    ... text
    ... apples_and_pears
    ... tpu_systolic_arrays
    ... ''')
    >>> index = default_brute_force_knn_document_index(
    ...     docs.text, docs, embedder=FakeEmbeddings(), dimensions=16, device="cpu"
    ... )
    >>> queries = pw.debug.table_from_markdown('q\ntpu_systolic_arrays')
    >>> res = index.query_as_of_now(queries.q, number_of_matches=1).select(
    ...     match=pw.this.text
    ... )
    >>> pw.debug.compute_and_print(res, include_id=False)
    match
    ('tpu_systolic_arrays',)
    """
    inner = BruteForceKnn(
        data_column,
        metadata_column,
        dimensions=dimensions,
        metric=DistanceMetric.COS,
        embedder=embedder,
        device=device,
    )
    return DataIndex(data_table, inner)


def default_lsh_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    embedder=None,
    dimensions: int,
    metadata_column: ColumnReference | None = None,
) -> DataIndex:
    inner = LshKnn(
        data_column,
        metadata_column,
        dimensions=dimensions,
        embedder=embedder,
    )
    return DataIndex(data_table, inner)

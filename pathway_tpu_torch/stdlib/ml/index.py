"""Classic KNNIndex facade (parity: stdlib/ml/index.py:9-194).

Wraps stdlib.indexing; kept for API compatibility with the reference's
``pw.ml.index.KNNIndex`` used by the legacy VectorStoreServer path.  A
copy of ``pathway_tpu/stdlib/ml/index.py``; ``device`` is the port's own:
the index runs on ``cuda:0`` unless it names another device.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ApplyExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    DistanceMetric,
    LshKnn,
)


class KNNIndex:
    """K-nearest-neighbours index over an embedding column."""

    def __init__(
        self,
        data_embedding: ColumnReference,
        data: Table,
        n_dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: str = "euclidean",
        metadata: ColumnReference | None = None,
        *,
        device=None,
    ):
        metric = (
            DistanceMetric.L2SQ if distance_type == "euclidean" else DistanceMetric.COS
        )
        inner = BruteForceKnn(
            data_embedding, metadata, dimensions=n_dimensions, metric=metric, device=device
        )
        self._index = DataIndex(data, inner)
        self._data = data

    def get_nearest_items(
        self,
        query_embedding: ColumnReference,
        k: int | ColumnReference = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnReference | None = None,
    ) -> Table:
        result = self._index.query(
            query_embedding,
            number_of_matches=k,
            collapse_rows=collapse_rows,
            metadata_filter=metadata_filter,
        )
        if not with_distances and "_pw_index_reply_score" in result.column_names():
            result = result.without("_pw_index_reply_score")
        else:
            result = result.rename_columns(dist=this._pw_index_reply_score)
        return result

    def get_nearest_items_asof_now(
        self,
        query_embedding: ColumnReference,
        k: int | ColumnReference = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnReference | None = None,
    ) -> Table:
        result = self._index.query_as_of_now(
            query_embedding,
            number_of_matches=k,
            collapse_rows=collapse_rows,
            metadata_filter=metadata_filter,
        )
        if not with_distances and "_pw_index_reply_score" in result.column_names():
            result = result.without("_pw_index_reply_score")
        else:
            result = result.rename_columns(dist=this._pw_index_reply_score)
        return result


__all__ = ["KNNIndex", "DistanceMetric"]

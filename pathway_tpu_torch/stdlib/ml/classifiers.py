"""Simple classifiers over indexes (parity: stdlib/ml/classifiers/).

``knn_lsh_classifier_train`` / ``classify`` — majority vote over LSH KNN.
A copy of ``pathway_tpu/stdlib/ml/classifiers.py``; ``device`` is the
port's own: the index runs on ``cuda:0`` unless it names another device.
"""

from __future__ import annotations

from collections import Counter

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ApplyExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this
from pathway_tpu_torch.stdlib.ml.index import KNNIndex


def knn_lsh_classifier_train(
    data: Table, L: int = 20, type: str = "euclidean", *, device=None, **kwargs
):
    """Returns a classify(labels, queries, k) callable over the trained index."""
    n_dimensions = kwargs.get("d", kwargs.get("n_dimensions", 128))
    index = KNNIndex(
        ColumnReference(data, "data"), data, n_dimensions=n_dimensions,
        distance_type=type, device=device,
    )

    def classify(labels: Table, queries: Table, k: int = 3) -> Table:
        labeled = data.with_columns(label=labels.label)
        idx = KNNIndex(
            ColumnReference(labeled, "data"),
            labeled,
            n_dimensions=n_dimensions,
            distance_type=type,
            device=device,
        )
        matches = idx.get_nearest_items(ColumnReference(queries, "data"), k=k)

        def majority(lbls):
            if not lbls:
                return None
            return Counter(lbls).most_common(1)[0][0]

        return matches.select(
            predicted_label=ApplyExpression(majority, None, ColumnReference(this, "label"))
        )

    return classify


__all__ = ["knn_lsh_classifier_train"]

"""stdlib.ml (parity: stdlib/ml/): KNN index, classifiers, smart_table_ops, hmm, datasets."""

from pathway_tpu_torch.stdlib.ml import classifiers, hmm, index, smart_table_ops

__all__ = ["classifiers", "hmm", "index", "smart_table_ops"]

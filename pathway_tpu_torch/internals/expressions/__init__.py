from pathway_tpu_torch.internals.expressions.date_time import DateTimeNamespace
from pathway_tpu_torch.internals.expressions.numerical import NumericalNamespace
from pathway_tpu_torch.internals.expressions.string import StringNamespace

__all__ = ["DateTimeNamespace", "NumericalNamespace", "StringNamespace"]

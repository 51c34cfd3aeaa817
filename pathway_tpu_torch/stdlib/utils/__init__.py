"""stdlib.utils (parity: stdlib/utils/): col helpers, filtering, bucketing,
AsyncTransformer, pandas_transformer."""

from pathway_tpu_torch.stdlib.utils.col import unpack_col, flatten_column
from pathway_tpu_torch.stdlib.utils.filtering import argmax_rows, argmin_rows
from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer
from pathway_tpu_torch.stdlib.utils.pandas_transformer import pandas_transformer

__all__ = [
    "unpack_col",
    "flatten_column",
    "argmax_rows",
    "argmin_rows",
    "AsyncTransformer",
    "pandas_transformer",
]

"""``@pw.pandas_transformer`` (parity: stdlib/utils/pandas_transformer.py).

Runs a pandas function over full (static) tables — the reference implements
it via ``apply`` over packed columns; here the capture/rebuild round-trips
through the debug helpers.
"""

from __future__ import annotations

import functools
from typing import Callable

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table


def pandas_transformer(output_schema: type[schema_mod.Schema], output_universe=None):
    def decorator(func: Callable) -> Callable:
        @functools.wraps(func)
        def wrapper(*tables: Table) -> Table:
            import pathway_tpu_torch.debug as dbg

            dfs = [dbg.table_to_pandas(t, include_id=False) for t in tables]
            result_df = func(*dfs)
            return dbg.table_from_pandas(result_df, schema=output_schema)

        return wrapper

    return decorator


__all__ = ["pandas_transformer"]

"""Column utilities (parity: stdlib/utils/col.py)."""

from __future__ import annotations

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this


def unpack_col(column: ColumnReference, *unpacked_columns, schema=None) -> Table:
    """Unpack a tuple column into named columns."""
    table = column.table
    if schema is not None:
        names = list(schema.__columns__.keys())
    else:
        names = [
            c.name if isinstance(c, ColumnReference) else str(c)
            for c in unpacked_columns
        ]
    exprs = {}
    for i, n in enumerate(names):
        exprs[n] = expr_mod.ApplyExpression(
            lambda t, _i=i: t[_i], None, column
        )
    return table.select(**exprs)


def flatten_column(column: ColumnReference, origin_id: str | None = "origin_id") -> Table:
    table = column.table
    return table.flatten(column, origin_id=origin_id)


__all__ = ["unpack_col", "flatten_column"]

"""Ordered-table helpers (parity: stdlib/ordered/diff).

``pw.Table.diff`` — difference between a row and the previous row in the
order given by ``timestamp``, computed via the engine's sort (prev/next)
operator.
"""

from __future__ import annotations

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this


def diff(table: Table, timestamp, *values, instance=None) -> Table:
    r"""Per-row difference vs the previous row in ``timestamp`` order
    (parity: stdlib/ordered/diff).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('t | v\n1 | 10\n2 | 13\n4 | 19')
    >>> r = pw.ordered.diff(t, pw.this.t, pw.this.v)
    >>> pw.debug.compute_and_print(r.select(pw.this.t, pw.this.diff_v), include_id=False)
    t | diff_v
    1 | None
    2 | 3
    4 | 6
    """
    sorted_t = table.sort(key=timestamp, instance=instance)
    exprs = {}
    for v in values:
        name = v.name if isinstance(v, ColumnReference) else str(v)
        prev_view = table.ix(sorted_t.prev, optional=True)
        exprs["diff_" + name] = expr_mod.if_else(
            getattr(prev_view, name).is_none() if hasattr(prev_view, name) else expr_mod.ColumnConstExpression(True),
            expr_mod.ColumnConstExpression(None),
            getattr(this, name) - getattr(prev_view, name),
        )
    out = table.with_columns(**exprs)
    return out


__all__ = ["diff"]

"""Statistical helpers (parity: stdlib/statistical: interpolate)."""

from __future__ import annotations

import enum

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this


class InterpolateMode(enum.Enum):
    LINEAR = 0


def interpolate(
    table: Table, timestamp, *values, mode: InterpolateMode = InterpolateMode.LINEAR
) -> Table:
    r"""Linear interpolation of missing values along the timestamp order
    (parity: stdlib/statistical/interpolate).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('t | v\n0 | 0.0\n2 |\n4 | 4.0')
    >>> r = pw.statistical.interpolate(t, pw.this.t, pw.this.v)
    >>> pw.debug.compute_and_print(r, include_id=False)
    t | v
    0 | 0.0
    2 | 2.0
    4 | 4.0
    """
    sorted_t = table.sort(key=timestamp)
    t_name = timestamp.name if isinstance(timestamp, ColumnReference) else "_t"

    exprs = {}
    for v in values:
        name = v.name if isinstance(v, ColumnReference) else str(v)

        def make_interp(col_name):
            def interp(cur_val, prev_t, prev_v, next_t, next_v, cur_t):
                if cur_val is not None:
                    return cur_val
                if prev_v is None and next_v is None:
                    return None
                if prev_v is None:
                    return next_v
                if next_v is None:
                    return prev_v
                if next_t == prev_t:
                    return prev_v
                frac = (cur_t - prev_t) / (next_t - prev_t)
                return prev_v + (next_v - prev_v) * frac

            return interp

        prev_view = table.ix(sorted_t.prev, optional=True)
        next_view = table.ix(sorted_t.next, optional=True)
        exprs[name] = expr_mod.ApplyExpression(
            make_interp(name),
            None,
            getattr(this, name),
            getattr(prev_view, t_name),
            getattr(prev_view, name),
            getattr(next_view, t_name),
            getattr(next_view, name),
            getattr(this, t_name),
            _propagate_none=False,
        )
    return table.with_columns(**exprs)


__all__ = ["interpolate", "InterpolateMode"]

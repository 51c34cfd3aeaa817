"""``expr.num.*`` numerical method namespace.

Parity target: ``python/pathway/internals/expressions/numerical.py``.
"""

from __future__ import annotations

import math

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    MethodCallExpression,
)


class NumericalNamespace:
    r"""``col.num`` — numerical operations on column expressions.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('x\n-2.75\n3.5')
    >>> r = t.select(a=pw.this.x.num.abs(), rnd=pw.this.x.num.round(1))
    >>> pw.debug.compute_and_print(r, include_id=False)
    a    | rnd
    2.75 | -2.8
    3.5  | 3.5
    """
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    def _m(self, name, fun, ret, *args, propagate_none=True):
        return MethodCallExpression(
            f"num.{name}", fun, ret, [self._expr, *args], propagate_none=propagate_none
        )

    def abs(self):
        return self._m("abs", abs, lambda ts: ts[0])

    def round(self, decimals=0):
        return self._m(
            "round",
            lambda v, d: round(v, d) if d else float(round(v)) if isinstance(v, float) else round(v),
            lambda ts: ts[0],
            decimals,
        )

    def fill_na(self, default_value):
        def impl(v, d):
            if v is None:
                return d
            if isinstance(v, float) and math.isnan(v):
                return d
            return v

        return self._m(
            "fill_na",
            impl,
            lambda ts: dt.unoptionalize(ts[0]),
            default_value,
            propagate_none=False,
        )

"""Window joins (parity: stdlib/temporal/_window_join.py).

Rows of both sides are assigned to windows; pairs sharing a window (and the
on-keys) join.  Composed from window assignment (flatten) + equi-join.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ApplyExpression, ColumnReference
from pathway_tpu_torch.internals.table import JoinMode, JoinResult, Table
from pathway_tpu_torch.internals.thisclass import left as left_ph, right as right_ph, this
from pathway_tpu_torch.stdlib.temporal._window import Window


class WindowJoinResult:
    def __init__(self, left_assigned, right_assigned, on, mode, left_orig, right_orig):
        conds = list(on)
        conds.append(
            expr_mod.ColumnBinaryOpExpression(
                "==",
                ColumnReference(left_ph, "_pw_window"),
                ColumnReference(right_ph, "_pw_window"),
            )
        )
        self._jr = JoinResult(left_assigned, right_assigned, conds, mode=mode)
        self._left_orig = left_orig
        self._right_orig = right_orig
        self._left_assigned = left_assigned
        self._right_assigned = right_assigned

    def select(self, *args, **kwargs) -> Table:
        exprs: dict[str, Any] = {}
        for a in args:
            if isinstance(a, ColumnReference):
                exprs[a.name] = a
            else:
                raise ValueError("positional select args must be column refs")
        exprs.update(kwargs)
        mapping = {
            id(self._left_orig): self._left_assigned,
            id(self._right_orig): self._right_assigned,
        }
        final = {n: expr_mod._wrap(e)._substitute(mapping) for n, e in exprs.items()}
        return self._jr.select(**final)


def _assign(table: Table, time_expr, window: Window) -> Table:
    def windows_of(t):
        if t is None:
            return ()
        return tuple((s, e) for (s, e) in window._assign(t))

    w = table.with_columns(
        _pw_windows=ApplyExpression(windows_of, None, time_expr),
    )
    flat = w.flatten(ColumnReference(this, "_pw_windows"))
    return flat.with_columns(_pw_window=ColumnReference(this, "_pw_windows")).without(
        "_pw_windows"
    )


def window_join(
    self: Table,
    other: Table,
    self_time,
    other_time,
    window: Window,
    *on,
    how: JoinMode = JoinMode.INNER,
) -> WindowJoinResult:
    left_assigned = _assign(self, self_time, window)
    right_assigned = _assign(other, other_time, window)
    conds = []
    for cond in on:
        conds.append(
            expr_mod.ColumnBinaryOpExpression(
                "==",
                cond._left._substitute({id(self): left_assigned, id(this): left_assigned}),
                cond._right._substitute({id(other): right_assigned, id(this): right_assigned}),
            )
        )
    # substitute original table refs onto assigned tables
    fixed = []
    for cond in on:
        l_e = _sub_table(cond._left, self, left_assigned, other, right_assigned)
        r_e = _sub_table(cond._right, self, left_assigned, other, right_assigned)
        fixed.append(expr_mod.ColumnBinaryOpExpression("==", l_e, r_e))
    return WindowJoinResult(left_assigned, right_assigned, fixed, how, self, other)


def _sub_table(e, l_orig, l_new, r_orig, r_new):
    return e._substitute({id(l_orig): l_new, id(r_orig): r_new})


def window_join_inner(self, other, self_time, other_time, window, *on, **kw):
    kw.pop("how", None)
    return window_join(self, other, self_time, other_time, window, *on, how=JoinMode.INNER, **kw)


def window_join_left(self, other, self_time, other_time, window, *on, **kw):
    kw.pop("how", None)
    return window_join(self, other, self_time, other_time, window, *on, how=JoinMode.LEFT, **kw)


def window_join_right(self, other, self_time, other_time, window, *on, **kw):
    kw.pop("how", None)
    return window_join(self, other, self_time, other_time, window, *on, how=JoinMode.RIGHT, **kw)


def window_join_outer(self, other, self_time, other_time, window, *on, **kw):
    kw.pop("how", None)
    return window_join(self, other, self_time, other_time, window, *on, how=JoinMode.OUTER, **kw)

"""Interval joins (parity: stdlib/temporal/_interval_join.py:577-1404).

``interval_join(left, right, left_time, right_time, interval(a, b), *on)``
pairs rows with ``a <= right_time - left_time <= b`` and equal on-keys.
Built from the incremental equi-join on the on-keys plus an interval filter;
outer modes add unmatched rows via incremental anti-join (difference on
matched key sets).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ApplyExpression, ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.table import JoinMode, JoinResult, Table
from pathway_tpu_torch.internals.thisclass import ThisPlaceholder, left as left_ph, right as right_ph, this


@dataclasses.dataclass(frozen=True)
class Interval:
    lower_bound: Any
    upper_bound: Any


def interval(lower_bound, upper_bound) -> Interval:
    return Interval(lower_bound, upper_bound)


class IntervalJoinResult:
    def __init__(self, left_t, right_t, left_time, right_time, iv, on, mode):
        self._left = left_t
        self._right = right_t
        self._left_time = left_time
        self._right_time = right_time
        self._interval = iv
        self._mode = mode
        self._on = on

    def select(self, *args, **kwargs) -> Table:
        exprs: dict[str, Any] = {}
        for a in args:
            if isinstance(a, ColumnReference):
                exprs[a.name] = a
            else:
                raise ValueError("positional select args must be column refs")
        exprs.update(kwargs)

        lt = self._left_time._substitute({id(this): self._left, id(left_ph): self._left})
        rt = self._right_time._substitute({id(this): self._right, id(right_ph): self._right})
        iv = self._interval

        # inner pairs via equi-join + interval filter
        jr = JoinResult(self._left, self._right, self._on, mode=JoinMode.INNER)
        lt_j = self._left_time._substitute({id(this): left_ph, id(left_ph): left_ph})
        rt_j = self._right_time._substitute({id(this): right_ph, id(right_ph): right_ph})
        # rebind refs of the original tables onto left/right placeholders
        lt_j = _rebind(lt, self._left, "left")
        rt_j = _rebind(rt, self._right, "right")
        diff_e = rt_j - lt_j
        cond = (diff_e >= iv.lower_bound) & (diff_e <= iv.upper_bound)
        sel = dict(exprs)
        sel["_pw_in_interval"] = cond
        inner = jr.select(**sel)
        inner = inner.filter(ColumnReference(this, "_pw_in_interval")).without(
            "_pw_in_interval"
        )
        if self._mode == JoinMode.INNER:
            return inner

        # outer parts: rows with no in-interval partner get None-padded output
        results = [inner]
        if self._mode in (JoinMode.LEFT, JoinMode.OUTER):
            results.append(self._unmatched_side(exprs, side="left", jr_mode=jr))
        if self._mode in (JoinMode.RIGHT, JoinMode.OUTER):
            results.append(self._unmatched_side(exprs, side="right", jr_mode=jr))
        # the three parts keep their source tables' row keys, which can
        # collide across sides — reindex while concatenating
        return results[0].concat_reindex(*results[1:])

    def _unmatched_side(self, exprs, side: str, jr_mode) -> Table:
        """Rows of one side with no interval match, None-padded."""
        base = self._left if side == "left" else self._right
        other = self._right if side == "left" else self._left
        # matched ids of this side
        jr = JoinResult(self._left, self._right, self._on, mode=JoinMode.INNER)
        lt_j = _rebind(
            self._left_time._substitute({id(this): self._left, id(left_ph): self._left}),
            self._left,
            "left",
        )
        rt_j = _rebind(
            self._right_time._substitute({id(this): self._right, id(right_ph): self._right}),
            self._right,
            "right",
        )
        diff_e = rt_j - lt_j
        iv = self._interval
        cond = (diff_e >= iv.lower_bound) & (diff_e <= iv.upper_bound)
        side_id = (
            ColumnReference(left_ph, "id") if side == "left" else ColumnReference(right_ph, "id")
        )
        matched_pairs = jr.select(_pw_matched_id=side_id, _pw_ok=cond)
        matched_pairs = matched_pairs.filter(ColumnReference(this, "_pw_ok"))
        matched_ids = matched_pairs.groupby(
            ColumnReference(this, "_pw_matched_id")
        ).reduce(_pw_matched_id=ColumnReference(this, "_pw_matched_id"))
        matched_keyed = matched_ids.with_id(ColumnReference(this, "_pw_matched_id"))
        unmatched = base.difference(matched_keyed)
        # project expressions with other-side references → None
        sel = {}
        for n, e in exprs.items():
            sel[n] = _null_other_side(expr_mod._wrap(e), other, side)
        return unmatched.select(**sel)


def _rebind(e: ColumnExpression, table: Table, side: str) -> ColumnExpression:
    ph = left_ph if side == "left" else right_ph

    def walk(x):
        if isinstance(x, ColumnReference):
            if x.table is table:
                return ColumnReference(ph, x.name)
            return x
        new = x._substitute({})
        _walk_children(new, walk)
        return new

    return walk(e)


def _null_other_side(e: ColumnExpression, other: Table, keep_side: str) -> ColumnExpression:
    keep_ph = left_ph if keep_side == "left" else right_ph
    drop_ph = right_ph if keep_side == "left" else left_ph

    def walk(x):
        if isinstance(x, ColumnReference):
            if x.table is other or (
                isinstance(x.table, ThisPlaceholder) and x.table._kind == getattr(drop_ph, "_kind")
            ):
                return expr_mod.ColumnConstExpression(None)
            if isinstance(x.table, ThisPlaceholder) and x.table._kind == getattr(keep_ph, "_kind"):
                return ColumnReference(this, x.name)
            if x.table is not other and isinstance(x.table, Table):
                return ColumnReference(this, x.name)
            return x
        new = x._substitute({})
        _walk_children(new, walk)
        return new

    return walk(e)


def _walk_children(e, fn):
    for attr in getattr(e, "__slots__", ()):
        try:
            v = getattr(e, attr)
        except AttributeError:
            continue
        if isinstance(v, ColumnReference):
            object.__setattr__(e, attr, fn(v))
        elif isinstance(v, ColumnExpression):
            _walk_children(v, fn)
        elif isinstance(v, tuple) and any(isinstance(x, ColumnExpression) for x in v):
            object.__setattr__(
                e,
                attr,
                tuple(
                    fn(x)
                    if isinstance(x, ColumnReference)
                    else x
                    for x in v
                ),
            )
        elif isinstance(v, dict):
            for k2, x in list(v.items()):
                if isinstance(x, ColumnReference):
                    v[k2] = fn(x)
                elif isinstance(x, ColumnExpression):
                    _walk_children(x, fn)


def interval_join(
    self: Table,
    other: Table,
    self_time,
    other_time,
    iv: Interval,
    *on,
    how: JoinMode = JoinMode.INNER,
    behavior=None,
) -> IntervalJoinResult:
    r"""``pw.temporal.interval_join`` (reference _interval_join.py:577).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> a = pw.debug.table_from_markdown('t | v\n1 | x\n5 | y')
    >>> b = pw.debug.table_from_markdown('t | w\n2 | p\n9 | q')
    >>> r = pw.temporal.interval_join(
    ...     a, b, a.t, b.t, pw.temporal.interval(-1, 1)
    ... ).select(a.v, b.w)
    >>> pw.debug.compute_and_print(r, include_id=False)
    v | w
    x | p
    """
    return IntervalJoinResult(self, other, self_time, other_time, iv, on, how)


def interval_join_inner(self, other, self_time, other_time, iv, *on, **kw):
    kw.pop("how", None)
    return interval_join(self, other, self_time, other_time, iv, *on, how=JoinMode.INNER, **kw)


def interval_join_left(self, other, self_time, other_time, iv, *on, **kw):
    kw.pop("how", None)
    return interval_join(self, other, self_time, other_time, iv, *on, how=JoinMode.LEFT, **kw)


def interval_join_right(self, other, self_time, other_time, iv, *on, **kw):
    kw.pop("how", None)
    return interval_join(self, other, self_time, other_time, iv, *on, how=JoinMode.RIGHT, **kw)


def interval_join_outer(self, other, self_time, other_time, iv, *on, **kw):
    kw.pop("how", None)
    return interval_join(self, other, self_time, other_time, iv, *on, how=JoinMode.OUTER, **kw)

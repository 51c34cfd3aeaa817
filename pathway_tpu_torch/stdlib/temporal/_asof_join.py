"""As-of joins (parity: stdlib/temporal/_asof_join.py:479-1000).

Incremental construction from engine primitives: the right side is folded
per join-key into a sorted tuple of (time, row) entries (an incremental
groupby), the left side left-joins that fold, and per-row binary search
picks the as-of match.  A change on either side retracts and re-emits only
the affected rows — the same net behavior as the reference's dedicated
prev/next pointer machinery (prev_next.rs), chosen here because the fold
keeps per-key state contiguous, which is the layout a future device-side
batch lookup wants.
"""

from __future__ import annotations

import bisect
import enum
from typing import Any

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    ColumnExpression,
    ColumnReference,
)
from pathway_tpu_torch.internals.table import JoinMode, JoinResult, Table
from pathway_tpu_torch.internals.thisclass import ThisPlaceholder, left as left_ph, right as right_ph, this


class Direction(enum.Enum):
    BACKWARD = 0
    FORWARD = 1
    NEAREST = 2


def _lookup(entries, lt, direction: Direction):
    """entries: sorted tuple of (time, row_tuple); find the as-of entry."""
    if entries is None or len(entries) == 0 or lt is None:
        return None
    times = [e[0] for e in entries]
    if direction is Direction.BACKWARD:
        i = bisect.bisect_right(times, lt) - 1
        return entries[i] if i >= 0 else None
    if direction is Direction.FORWARD:
        i = bisect.bisect_left(times, lt)
        return entries[i] if i < len(entries) else None
    # NEAREST
    i = bisect.bisect_left(times, lt)
    best = None
    for j in (i - 1, i):
        if 0 <= j < len(entries):
            d = abs(entries[j][0] - lt)
            if best is None or d < best[0]:
                best = (d, entries[j])
    return best[1] if best else None


class AsofJoinResult:
    def __init__(
        self,
        left_table: Table,
        right_table: Table,
        left_time,
        right_time,
        on,
        mode: JoinMode,
        defaults: dict | None = None,
        direction: Direction = Direction.BACKWARD,
    ):
        self._left = left_table
        self._orig_left = left_table
        self._right = right_table
        self._mode = mode
        self._defaults = {}
        for k, v in (defaults or {}).items():
            name = k.name if isinstance(k, ColumnReference) else k
            self._defaults[name] = v
        self._direction = direction
        self._left_time = left_time
        self._right_time = right_time
        self._r_names = right_table.column_names()

        # fold the right side per join key
        left_on, right_on = [], []
        for cond in on:
            if not isinstance(cond, expr_mod.ColumnBinaryOpExpression) or cond._op != "==":
                raise ValueError("asof_join conditions must be equalities")
            l_e, r_e = cond._left, cond._right
            if JoinResult._refers(r_e, left_table) or (
                isinstance(r_e, ColumnReference)
                and isinstance(r_e.table, ThisPlaceholder)
                and r_e.table._kind == "left"
            ):
                l_e, r_e = r_e, l_e
            left_on.append(l_e._substitute({id(left_ph): left_table, id(this): left_table}))
            right_on.append(r_e._substitute({id(right_ph): right_table, id(this): right_table}))

        entry_expr = expr_mod.make_tuple(
            right_time._substitute({id(this): right_table, id(right_ph): right_table}),
            expr_mod.make_tuple(*[ColumnReference(this, n) for n in self._r_names]),
        )
        if right_on:
            # grouping by expressions: select them first
            keyed_right = right_table.with_columns(
                **{f"_pw_k{i}": e for i, e in enumerate(right_on)}
            )
            folded = keyed_right.groupby(
                *[ColumnReference(this, f"_pw_k{i}") for i in range(len(right_on))]
            ).reduce(
                **{f"_pw_k{i}": ColumnReference(this, f"_pw_k{i}") for i in range(len(right_on))},
                _pw_entries=reducers.sorted_tuple(entry_expr),
            )
            on_conds = [
                expr_mod.ColumnBinaryOpExpression(
                    "==", left_on[i], ColumnReference(folded, f"_pw_k{i}")
                )
                for i in range(len(left_on))
            ]
            self._joined = JoinResult(left_table, folded, on_conds, mode=JoinMode.LEFT)
            self._folded = folded
        else:
            # no key: fold everything into one group and cross with left
            folded = right_table.reduce(
                _pw_all=expr_mod.ColumnConstExpression(0),
                _pw_entries=reducers.sorted_tuple(entry_expr),
            )
            keyed_left = left_table.with_columns(_pw_all=expr_mod.ColumnConstExpression(0))
            on_conds = [
                expr_mod.ColumnBinaryOpExpression(
                    "==",
                    ColumnReference(keyed_left, "_pw_all"),
                    ColumnReference(folded, "_pw_all"),
                )
            ]
            self._joined = JoinResult(keyed_left, folded, on_conds, mode=JoinMode.LEFT)
            self._left = keyed_left
            self._folded = folded

    def select(self, *args, **kwargs) -> Table:
        exprs: dict[str, Any] = {}
        for a in args:
            exprs[_ref_name(a)] = a
        exprs.update(kwargs)

        direction = self._direction
        defaults = self._defaults
        r_names = self._r_names
        lt_expr = self._left_time._substitute(
            {id(this): self._left, id(left_ph): self._left}
        )

        def fix_left(e: ColumnExpression) -> ColumnExpression:
            if isinstance(e, ColumnReference):
                if e.table is self._orig_left and e.table is not self._left:
                    return ColumnReference(self._left, e.name)
                return e
            new = e._substitute({})
            _rewrite_children(new, fix_left)
            return new

        lt_expr = fix_left(lt_expr)

        def right_col_expr(name: str) -> ColumnExpression:
            idx = r_names.index(name)
            default = defaults.get(name)

            def extract(entries, lt, _idx=idx, _default=default):
                e = _lookup(entries, lt, direction)
                if e is None:
                    return _default
                return e[1][_idx]

            return ApplyExpression(
                extract,
                None,
                ColumnReference(self._folded, "_pw_entries"),
                lt_expr,
                _propagate_none=False,
            )

        def substitute_right(e: ColumnExpression) -> ColumnExpression:
            if isinstance(e, ColumnReference):
                tbl = e.table
                if tbl is self._right or (
                    isinstance(tbl, ThisPlaceholder) and tbl._kind == "right"
                ):
                    return right_col_expr(e.name)
                if tbl is self._orig_left and tbl is not self._left:
                    # the unkeyed path wraps the left table; refs to the
                    # user's original table must land on the wrapped one
                    return ColumnReference(self._left, e.name)
                return e
            new = e._substitute({})
            _rewrite_children(new, substitute_right)
            return new

        final = {}
        for n, e in exprs.items():
            final[n] = substitute_right(expr_mod._wrap(e))
        result = self._joined.select(**final)
        if self._mode == JoinMode.INNER:

            def found(entries, lt):
                return _lookup(entries, lt, direction) is not None

            matched = self._joined.select(
                **final,
                _pw_found=ApplyExpression(
                    found,
                    None,
                    ColumnReference(self._folded, "_pw_entries"),
                    lt_expr,
                    _propagate_none=False,
                ),
            )
            result = matched.filter(ColumnReference(this, "_pw_found")).without(
                "_pw_found"
            )
        return result


def _ref_name(e) -> str:
    if isinstance(e, ColumnReference):
        return e.name
    raise ValueError("positional args of asof select must be column references")


def _rewrite_children(e, fn):
    for attr in getattr(e, "__slots__", ()):
        try:
            v = getattr(e, attr)
        except AttributeError:
            continue
        if isinstance(v, ColumnReference):
            object.__setattr__(e, attr, fn(v))
        elif isinstance(v, ColumnExpression):
            _rewrite_children(v, fn)
        elif isinstance(v, tuple) and any(isinstance(x, ColumnExpression) for x in v):
            object.__setattr__(
                e,
                attr,
                tuple(fn(x) if isinstance(x, ColumnReference) else (_rewrite_children(x, fn) or x) if isinstance(x, ColumnExpression) else x for x in v),
            )
        elif isinstance(v, dict):
            for k2, x in list(v.items()):
                if isinstance(x, ColumnReference):
                    v[k2] = fn(x)
                elif isinstance(x, ColumnExpression):
                    _rewrite_children(x, fn)


def asof_join(
    self: Table,
    other: Table,
    self_time,
    other_time,
    *on,
    how: JoinMode = JoinMode.INNER,
    defaults: dict | None = None,
    direction: Direction = Direction.BACKWARD,
    behavior=None,
) -> AsofJoinResult:
    r"""``pw.temporal.asof_join`` (reference _asof_join.py:479).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> trades = pw.debug.table_from_markdown('t | px\n3 | 100\n7 | 101')
    >>> quotes = pw.debug.table_from_markdown('t | bid\n2 | 99\n6 | 98')
    >>> r = pw.temporal.asof_join(
    ...     trades, quotes, trades.t, quotes.t, how=pw.temporal.Direction.BACKWARD
    ... ).select(trades.px, quotes.bid)
    >>> pw.debug.compute_and_print(r, include_id=False)
    px  | bid
    100 | 99
    101 | 98
    """
    return AsofJoinResult(
        self, other, self_time, other_time, on, mode=how, defaults=defaults, direction=direction
    )


def asof_join_left(self, other, self_time, other_time, *on, **kw) -> AsofJoinResult:
    kw.pop("how", None)
    return asof_join(self, other, self_time, other_time, *on, how=JoinMode.LEFT, **kw)


def asof_join_right(self, other, self_time, other_time, *on, **kw) -> AsofJoinResult:
    kw.pop("how", None)
    res = asof_join(
        other, self, other_time, self_time, *on, how=JoinMode.LEFT, **kw
    )
    res._swapped = True
    return res


def asof_join_outer(self, other, self_time, other_time, *on, **kw) -> AsofJoinResult:
    kw.pop("how", None)
    return asof_join(self, other, self_time, other_time, *on, how=JoinMode.LEFT, **kw)

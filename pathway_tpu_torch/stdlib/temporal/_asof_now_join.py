"""asof-now joins (parity: stdlib/temporal/_asof_now_join.py).

``asof_now_join`` matches each *arriving* left row against the right side's
current state; results are not revised when the right side later changes —
the query-stream semantics used by the RAG retrieval path (§3.4).
Implemented on a dedicated engine node that indexes the right side but only
reacts to left-side deltas.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any

from pathway_tpu_torch.engine import dataflow as df
from pathway_tpu_torch.engine.types import Error, hash_values, Pointer
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.internals.expression_evaluator import compile_expr
from pathway_tpu_torch.internals.table import (
    JoinMode,
    JoinResult,
    Lowerer,
    RowBinder,
    Table,
    Universe,
    _fetch_chain,
)
from pathway_tpu_torch.internals.thisclass import ThisPlaceholder, left as left_ph, right as right_ph, this


class AsofNowJoinNode(df.Node):
    """Port 0: left (query) stream; port 1: right (data) stream.

    Left inserts are matched against the current right index and the result
    is frozen; later right-side changes do not retract it.  Left deletions
    retract previously emitted results.
    """

    name = "asof_now_join"
    _persist_attrs = ("_right_idx", "_emitted")

    def __init__(self, scope, left_node, right_node, lkey_fn, rkey_fn, out_key_fn, left_outer):
        super().__init__(scope, [left_node, right_node])
        self.lkey_fn = lkey_fn
        self.rkey_fn = rkey_fn
        self.out_key_fn = out_key_fn
        self.left_outer = left_outer
        self._right_idx: dict[Any, dict[int, tuple]] = defaultdict(dict)
        self._emitted: dict[int, list] = {}

    def step(self, time):
        out = []
        # right side first: index updates happen-before matching this epoch
        for rkey, rrow, diff in df.consolidate(self.take_pending(1)):
            jk = self.rkey_fn(rkey, rrow)
            if jk is None:
                continue
            if diff > 0:
                self._right_idx[jk][rkey] = rrow
            else:
                self._right_idx[jk].pop(rkey, None)
                if not self._right_idx[jk]:
                    del self._right_idx[jk]
        for lkey, lrow, diff in df.consolidate(self.take_pending(0)):
            if diff > 0:
                jk = self.lkey_fn(lkey, lrow)
                matches = self._right_idx.get(jk, {}) if jk is not None else {}
                emitted = []
                if matches:
                    for rkey, rrow in matches.items():
                        okey = self.out_key_fn(lkey, rkey)
                        entry = (okey, (lkey, rkey, lrow, rrow), 1)
                        out.append(entry)
                        emitted.append(entry)
                elif self.left_outer:
                    okey = self.out_key_fn(lkey, None)
                    entry = (okey, (lkey, None, lrow, None), 1)
                    out.append(entry)
                    emitted.append(entry)
                self._emitted[lkey] = emitted
            else:
                for okey, row, _ in self._emitted.pop(lkey, []):
                    out.append((okey, row, -1))
        out = df.consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class AsofNowJoinResult(JoinResult):
    """Reuses JoinResult's select/binder machinery over the asof-now node."""

    def _lower_join(self, lowerer: Lowerer):
        lnode = lowerer.node(self._left)
        rnode = lowerer.node(self._right)
        lbinder = RowBinder(lowerer, self._left)
        rbinder = RowBinder(lowerer, self._right)
        l_fns = [compile_expr(e, lbinder) for e in self._left_on]
        r_fns = [compile_expr(e, rbinder) for e in self._right_on]
        lnode = _fetch_chain(lowerer, lnode, lbinder)
        rnode = _fetch_chain(lowerer, rnode, rbinder)

        def guard(fns):
            def f(key, row):
                vals = tuple(fn(key, row) for fn in fns)
                if any(v is None or isinstance(v, Error) for v in vals):
                    return None
                return vals

            return f

        id_param = self._id_param
        left_table = self._left

        def out_key_fn(lkey, rkey):
            if id_param is not None and isinstance(id_param, ColumnReference):
                if id_param.name == "id":
                    src = id_param.table
                    if src is left_table or (
                        isinstance(src, ThisPlaceholder) and src._kind == "left"
                    ):
                        return lkey
            return hash_values(
                [
                    Pointer(lkey) if lkey is not None else None,
                    Pointer(rkey) if rkey is not None else None,
                ]
            )

        return AsofNowJoinNode(
            lowerer.scope,
            lnode,
            rnode,
            guard(l_fns),
            guard(r_fns),
            out_key_fn,
            left_outer=self._mode == JoinMode.LEFT,
        )


def asof_now_join(
    self: Table, other: Table, *on, how: JoinMode = JoinMode.INNER, id=None, **kw
) -> AsofNowJoinResult:
    if how not in (JoinMode.INNER, JoinMode.LEFT):
        raise ValueError("asof_now_join supports INNER and LEFT modes")
    return AsofNowJoinResult(self, other, on, mode=how, id=id)


def asof_now_join_inner(self, other, *on, **kw) -> AsofNowJoinResult:
    kw.pop("how", None)
    return asof_now_join(self, other, *on, how=JoinMode.INNER, **kw)


def asof_now_join_left(self, other, *on, **kw) -> AsofNowJoinResult:
    kw.pop("how", None)
    return asof_now_join(self, other, *on, how=JoinMode.LEFT, **kw)

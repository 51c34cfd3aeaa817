"""Row-filtering helpers (parity: stdlib/utils/filtering.py)."""

from __future__ import annotations

from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.internals.table import Table


def _arg_rows(table: Table, *on, reducer) -> Table:
    grouped = table.groupby(*on[1:]) if len(on) > 1 else table.groupby()
    picked = grouped.reduce(_pw_pick=reducer(on[0]))
    keyed = picked.with_id(ColumnReference(None, "_pw_pick")) if False else picked
    from pathway_tpu_torch.internals.thisclass import this

    keyed = picked.with_id(this._pw_pick)
    return table.restrict(keyed)


def argmax_rows(table: Table, *on, what) -> Table:
    """Keep, per group of ``on[1:]`` columns, the row maximizing ``what``."""
    from pathway_tpu_torch.internals.thisclass import this

    grouped = table.groupby(*on) if on else table.groupby()
    picked = grouped.reduce(_pw_pick=reducers.argmax(what))
    keyed = picked.with_id(this._pw_pick)
    return table.restrict(keyed)


def argmin_rows(table: Table, *on, what) -> Table:
    from pathway_tpu_torch.internals.thisclass import this

    grouped = table.groupby(*on) if on else table.groupby()
    picked = grouped.reduce(_pw_pick=reducers.argmin(what))
    keyed = picked.with_id(this._pw_pick)
    return table.restrict(keyed)


__all__ = ["argmax_rows", "argmin_rows"]

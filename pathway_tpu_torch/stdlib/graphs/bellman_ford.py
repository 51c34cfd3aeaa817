"""Bellman–Ford shortest paths (parity: stdlib/graphs/bellman_ford.py)."""

from __future__ import annotations

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.internals.iterate import iterate
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import left as lp, right as rp, this


def bellman_ford(vertices: Table, edges: Table, iteration_limit: int | None = None) -> Table:
    r"""Single-source shortest paths (parity: stdlib/graphs/bellman_ford).

    ``vertices``: columns (is_source: bool); ``edges``: (u, v, dist) with
    u/v pointing at vertex ids.  Returns dist_from_source per vertex id.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> vertices = pw.debug.table_from_markdown('''
    ...   | is_source
    ... A | True
    ... B | False
    ... C | False
    ... ''')
    >>> edges = pw.debug.table_from_markdown('''
    ... lu | lv | dist
    ... A  | B  | 1.0
    ... B  | C  | 2.0
    ... A  | C  | 10.0
    ... ''').select(
    ...     u=vertices.pointer_from(pw.this.lu),
    ...     v=vertices.pointer_from(pw.this.lv),
    ...     dist=pw.this.dist,
    ... )
    >>> res = pw.graphs.bellman_ford(vertices, edges, iteration_limit=5)
    >>> pw.debug.compute_and_print(res, include_id=False)
    dist
    0.0
    1.0
    3.0
    """
    initial = vertices.select(
        dist=expr_mod.if_else(this.is_source, 0.0, float("inf"))
    )

    def step(state: Table) -> dict:
        relaxed = edges.join(
            state, ColumnReference(lp, "u") == ColumnReference(rp, "id")
        ).select(
            v=ColumnReference(lp, "v"),
            cand=ColumnReference(rp, "dist") + ColumnReference(lp, "dist"),
        )
        best = relaxed.groupby(this.v).reduce(
            v=this.v, cand=reducers.min(this.cand)
        )
        keyed_best = best.with_id(ColumnReference(this, "v"))
        # id=left.id keeps the state keyed by vertex id across rounds — the
        # next round's edges⋈state lookup depends on it
        new_state = state.join_left(
            keyed_best,
            ColumnReference(lp, "id") == ColumnReference(rp, "id"),
            id=ColumnReference(lp, "id"),
        ).select(
            dist=expr_mod.apply_with_type(
                lambda d, c: d if c is None else min(d, c),
                float,
                ColumnReference(lp, "dist"),
                ColumnReference(rp, "cand"),
            ),
        )
        return dict(state=new_state)

    result = iterate(lambda state: step(state), iteration_limit=iteration_limit, state=initial)
    return result


__all__ = ["bellman_ford"]

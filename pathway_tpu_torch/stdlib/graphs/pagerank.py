"""PageRank (parity: stdlib/graphs/pagerank.py) via pw.iterate."""

from __future__ import annotations

from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.internals.iterate import iterate
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this


def pagerank(edges: Table, steps: int = 5, damping: int = 85) -> Table:
    """Integer-arithmetic pagerank over an edge table (columns u, v).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> from pathway_tpu_torch.stdlib.graphs.pagerank import pagerank
    >>> edges = pw.debug.table_from_markdown('''
    ... u | v
    ... a | b
    ... a | c
    ... b | c
    ... c | a
    ... ''')
    >>> g = edges.select(u=edges.pointer_from(pw.this.u), v=edges.pointer_from(pw.this.v))
    >>> ranks = pagerank(g, steps=3)
    >>> pw.debug.compute_and_print(ranks.select(pw.this.rank), include_id=False)
    rank
    104
    120
    71
    """
    # out-degrees
    degrees = edges.groupby(this.u).reduce(u=this.u, degree=reducers.count())
    vertices = (
        edges.select(v=this.u)
        .concat_reindex(edges.select(v=this.v))
        .groupby(this.v)
        .reduce(v=this.v)
    )

    def one_step(ranks: Table) -> dict:
        # flow along edges: each u sends rank/degree to each v
        from pathway_tpu_torch.internals.thisclass import left as lp, right as rp
        import pathway_tpu_torch.internals.expression as expr_mod

        with_deg = edges.join(
            degrees, ColumnReference(lp, "u") == ColumnReference(rp, "u")
        ).select(
            u=ColumnReference(lp, "u"),
            v=ColumnReference(lp, "v"),
            degree=ColumnReference(rp, "degree"),
        )
        with_rank = with_deg.join(
            ranks, ColumnReference(lp, "u") == ColumnReference(rp, "v")
        ).select(
            v=ColumnReference(lp, "v"),
            flow=ColumnReference(rp, "rank") // ColumnReference(lp, "degree"),
        )
        inflow = with_rank.groupby(this.v).reduce(
            v=this.v, total=reducers.sum(this.flow)
        )
        new_ranks = vertices.join_left(
            inflow, ColumnReference(lp, "v") == ColumnReference(rp, "v")
        ).select(
            v=ColumnReference(lp, "v"),
            rank=(100 - damping)
            + (damping * expr_mod.coalesce(ColumnReference(rp, "total"), 0)) // 100,
        )
        return dict(ranks=new_ranks)

    initial = vertices.select(v=this.v, rank=100)
    result = iterate(
        lambda ranks: one_step(ranks), iteration_limit=steps, ranks=initial
    )
    return result


__all__ = ["pagerank"]

"""One level of Louvain community detection (parity: stdlib/graphs/louvain_communities.py).

Simplified greedy modularity pass: each vertex adopts the community that the
plurality of its neighbours hold, iterated to stability.
"""

from __future__ import annotations

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.internals.iterate import iterate
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import left as lp, right as rp, this


def louvain_level(edges: Table, iteration_limit: int = 10) -> Table:
    """edges: (u, v) undirected; returns (v, community)."""
    vertices = (
        edges.select(v=this.u)
        .concat_reindex(edges.select(v=this.v))
        .groupby(this.v)
        .reduce(v=this.v)
    )
    both_dirs = edges.select(u=this.u, v=this.v).concat_reindex(
        edges.select(u=this.v, v=this.u)
    )
    initial = vertices.select(v=this.v, community=this.v)

    def step(assign: Table) -> dict:
        # join on column values, not row ids — v labels are arbitrary values
        # (strings/ints), so rekeying the assignment via with_id would break
        neigh = both_dirs.join(
            assign, ColumnReference(lp, "v") == ColumnReference(rp, "v")
        ).select(u=ColumnReference(lp, "u"), community=ColumnReference(rp, "community"))
        votes = neigh.groupby(this.u, this.community).reduce(
            u=this.u, community=this.community, n=reducers.count()
        )
        # deterministic preference: plurality, then the vertex's current
        # community (stops synchronous-update oscillation), then min label
        flagged = votes.join(
            assign, ColumnReference(lp, "u") == ColumnReference(rp, "v")
        ).select(
            u=ColumnReference(lp, "u"),
            community=ColumnReference(lp, "community"),
            score=expr_mod.make_tuple(
                ColumnReference(lp, "n"),
                expr_mod.if_else(
                    expr_mod.ColumnBinaryOpExpression(
                        "==",
                        ColumnReference(lp, "community"),
                        ColumnReference(rp, "community"),
                    ),
                    1,
                    0,
                ),
            ),
        )
        top = flagged.groupby(this.u).reduce(
            u=this.u, s=reducers.max(this.score)
        )
        tied = flagged.join(
            top, ColumnReference(lp, "u") == ColumnReference(rp, "u")
        ).select(
            u=ColumnReference(lp, "u"),
            community=ColumnReference(lp, "community"),
            ok=expr_mod.ColumnBinaryOpExpression(
                "==", ColumnReference(lp, "score"), ColumnReference(rp, "s")
            ),
        )
        chosen = (
            tied.filter(ColumnReference(this, "ok"))
            .groupby(this.u)
            .reduce(u=this.u, community=reducers.min(this.community))
        )
        # id=left.id keeps assignment rows keyed stably across rounds
        new_assign = assign.join_left(
            chosen,
            ColumnReference(lp, "v") == ColumnReference(rp, "u"),
            id=ColumnReference(lp, "id"),
        ).select(
            v=ColumnReference(lp, "v"),
            community=expr_mod.coalesce(
                ColumnReference(rp, "community"), ColumnReference(lp, "community")
            ),
        )
        return dict(assign=new_assign)

    return iterate(lambda assign: step(assign), iteration_limit=iteration_limit, assign=initial)


__all__ = ["louvain_level"]

"""``pw.universes`` — universe promises (parity: python/pathway/universes.py)."""

from __future__ import annotations

from pathway_tpu_torch.internals.table import Table


def promise_are_equal(*tables: Table) -> None:
    for t in tables[1:]:
        tables[0].promise_universes_are_equal(t)


def promise_is_subset_of(subset: Table, superset: Table) -> None:
    subset.promise_universe_is_subset_of(superset)


def promise_are_pairwise_disjoint(*tables: Table) -> None:
    pass


__all__ = ["promise_are_equal", "promise_is_subset_of", "promise_are_pairwise_disjoint"]

"""Stateful helpers (parity: stdlib/stateful: deduplicate)."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals.table import Table


def deduplicate(
    table: Table,
    *,
    value,
    instance=None,
    acceptor: Callable[[Any, Any], bool],
    persistent_id: str | None = None,
    name: str | None = None,
) -> Table:
    r"""Keep one row per instance; replace when acceptor(new, old) is True.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> from pathway_tpu_torch.stdlib.stateful import deduplicate
    >>> t = pw.debug.table_from_markdown('k | v | _time\na | 1 | 2\na | 9 | 4')
    >>> r = deduplicate(t, value=pw.this.v, instance=pw.this.k, acceptor=lambda new, old: new > old)
    >>> pw.debug.compute_and_print(r.select(pw.this.v), include_id=False)
    v
    9
    """
    return table.deduplicate(
        value=value, instance=instance, acceptor=acceptor, persistent_id=persistent_id, name=name
    )


__all__ = ["deduplicate"]

"""``pw.io.subscribe`` (parity: python/pathway/io/_subscribe.py)."""

from __future__ import annotations

from typing import Any, Callable, Protocol

from pathway_tpu_torch.engine.types import Pointer
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils


class OnFinishCallback(Protocol):
    """Callback called when the stream of changes ends, once per worker
    (parity: internals/table_subscription.py:12)."""

    def __call__(self) -> None: ...


class OnChangeCallback(Protocol):
    """Callback called on every change in the table with the key, the row
    as a dict, the change time, and whether the change is an addition
    (parity: internals/table_subscription.py:26)."""

    def __call__(
        self, key: Pointer, row: dict[str, Any], time: int, is_addition: bool
    ) -> None: ...


class OnTimeEndCallback(Protocol):
    """Callback called when a processing time (minibatch) finishes
    (parity: internals/table_subscription.py:60)."""

    def __call__(self, time: int) -> None: ...


def subscribe(
    table: Table,
    on_change: Callable[..., None] | None = None,
    on_end: Callable[[], None] | None = None,
    on_time_end: Callable[[int], None] | None = None,
    *,
    name: str | None = None,
) -> None:
    """Call ``on_change(key, row, time, is_addition)`` for every change."""
    names = table.column_names()

    def on_data(key, row, time, diff):
        if on_change is not None:
            on_change(
                key=Pointer(key),
                row=dict(zip(names, row)),
                time=time,
                is_addition=diff > 0,
            )

    _utils.register_output(
        table,
        on_data,
        on_time_end=on_time_end,
        on_end=on_end,
        name=name or "subscribe",
    )

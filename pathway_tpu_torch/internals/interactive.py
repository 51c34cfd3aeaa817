"""Interactive live tables.

Parity target: ``python/pathway/internals/interactive.py``
(LiveTable/LiveTableState/LiveTableThread, 222 LoC) and
``internals/table.py:2565`` ``Table.live()``.

``table.live()`` runs the table's sink cone on a background thread (an
export sink through :mod:`export_import`) and returns a ``LiveTable`` —
a real :class:`Table` backed by the exported stream, so it can be both
inspected (``snapshot()``/``__str__``) and composed into further graph
operations that a later ``pw.run()`` executes.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any

from pathway_tpu_torch.internals import export_import as ei
from pathway_tpu_torch.internals.table import Table


@dataclass(frozen=True)
class LiveTableSnapshot:
    """Consolidated state of a live table at a frontier."""

    frontier: int
    done: bool
    data: list[tuple[int, tuple]]  # (key, row values)

    def __str__(self) -> str:
        header = (
            "final snapshot" if self.done else f"snapshot at time {self.frontier}"
        )
        return header + "\n" + "\n".join(
            f"  {key:x}: {row}" for key, row in self.data
        )


class LiveTable(Table):
    """A table whose origin graph runs on a background thread.

    Usable like any Table (select/filter/join then ``pw.run()``); also
    inspectable while the origin stream is still running.
    """

    _exported: ei.ExportedTable
    _thread: threading.Thread

    @classmethod
    def _create(cls, origin: Table) -> "LiveTable":
        from pathway_tpu_torch.internals.config import get_config

        if get_config().processes > 1:
            # the background run() would build a second TcpMesh on the
            # same ports as the main run and the two would cross-connect
            raise RuntimeError(
                "Table.live() is single-process only (the live thread "
                "runs its own graph; a multi-process mesh cannot be "
                "shared across two concurrent runs)"
            )
        exported = ei.ExportedTable(origin.schema)

        def attach(lowerer, node):
            return ei._ExportNode(lowerer.scope, node, exported)

        from pathway_tpu_torch.internals.runner import run

        def target():
            try:
                run(_sinks=[("live-export", origin, attach)])
            except BaseException:  # noqa: BLE001 — surfaced via failed()
                exported._finish(failed=True)

        thread = threading.Thread(
            target=target, name=f"pathway:live-{id(origin):x}", daemon=True
        )
        thread.start()

        imported = ei.import_table(exported)
        live = cls(imported.schema, imported._build_fn, universe=imported._universe)
        live._exported = exported
        live._thread = thread
        return live

    # -- inspection ------------------------------------------------------
    def failed(self) -> bool:
        return self._exported.failed

    def frontier(self) -> int:
        return self._exported.frontier()

    def snapshot_at(self, frontier: int) -> LiveTableSnapshot:
        """Consolidate the exported update stream up to ``frontier``."""
        rows, _off = self._exported.data_from_offset(0)
        counts: dict[tuple[int, tuple], int] = {}
        for key, row, time, diff in rows:
            if time <= frontier:
                counts[(key, row)] = counts.get((key, row), 0) + diff
        data = sorted(
            (key, row) for (key, row), c in counts.items() for _ in range(max(c, 0))
        )
        return LiveTableSnapshot(frontier, self._exported.done, data)

    def snapshot(self) -> LiveTableSnapshot:
        return self.snapshot_at(self.frontier())

    def wait_for(self, timeout: float = 10.0) -> "LiveTable":
        """Block until the origin stream finishes (testing/scripting aid)."""
        self._thread.join(timeout)
        return self

    def live(self) -> "LiveTable":
        return self

    def __str__(self) -> str:
        return str(self.snapshot())


class InteractiveModeController:
    """REPL display hook: live tables and snapshots print as their current
    contents instead of ``<object at 0x...>`` (reference
    ``interactive.py:180-203``).  One controller per process; created by
    :func:`enable_interactive_mode`."""

    def __init__(self, _pathway_internal: bool = False):
        assert _pathway_internal, "use pw.enable_interactive_mode()"
        import sys

        self._orig_displayhook = sys.displayhook
        sys.displayhook = self._displayhook

    def _displayhook(self, value: object) -> None:
        if isinstance(value, (LiveTable, LiveTableSnapshot)):
            import builtins

            builtins._ = value
            print(str(value))
        else:
            self._orig_displayhook(value)

    def disable(self) -> None:
        import sys

        sys.displayhook = self._orig_displayhook
        global _interactive_controller
        _interactive_controller = None


_interactive_controller: InteractiveModeController | None = None


def is_interactive_mode_enabled() -> bool:
    return _interactive_controller is not None


def enable_interactive_mode() -> InteractiveModeController:
    """``pw.enable_interactive_mode()`` — experimental, like the reference."""
    import warnings

    global _interactive_controller
    warnings.warn("interactive mode is experimental", stacklevel=2)
    if _interactive_controller is None:
        _interactive_controller = InteractiveModeController(_pathway_internal=True)
    return _interactive_controller

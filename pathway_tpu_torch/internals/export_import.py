"""Inter-graph table export/import.

Parity target: ``src/engine/dataflow/export.rs:1-205`` and
the Graph-trait surface ``graph.rs:978-984``.  An ``ExportedTable`` is a
thread-safe handle that one graph fills while it runs (rows + a time
frontier) and another graph — typically built after ``G.clear()`` or
running concurrently on another thread — consumes as an input source,
preserving keys, epoch boundaries, and retractions.

The reference wires this through an ``inspect_batch`` on the exporting
dataflow and an ``InputSession`` poller on the importing one; here the
export side is an ``OutputNode`` sink (epoch deltas + ``flush`` frontier
advances) and the import side is a runner poller that stages rows into an
``InputNode`` at their original times (the importing runner folds them
into its own epochs in order, exactly like any other source).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any

from pathway_tpu_torch.engine import dataflow as df
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table, Universe


class ImportedTableFailed(RuntimeError):
    """The exporting graph failed before finishing (Error::ImportedTableFailed)."""


class ExportedTable:
    """Cross-graph table handle: rows + frontier, filled by the exporter.

    Mirrors export.rs's ExportedTable: ``data_from_offset`` hands out the
    append-only row log incrementally; ``frontier`` is the last closed
    epoch time; ``done``/``failed`` are terminal states.
    """

    def __init__(self, schema: Any):
        self.schema = schema
        self._cond = threading.Condition()
        self._rows: list[tuple[int, tuple, int, int]] = []  # key, row, time, diff
        self._frontier = -1  # static epochs run at time 0, so "nothing closed" is -1
        self._done = False
        self._failed = False

    # -- exporter side ---------------------------------------------------
    def _push(self, key: int, row: tuple, time: int, diff: int) -> None:
        with self._cond:
            self._rows.append((key, row, time, diff))
            self._cond.notify_all()

    def _advance(self, time: int) -> None:
        with self._cond:
            if time > self._frontier:
                self._frontier = time
                self._cond.notify_all()

    def _finish(self, failed: bool = False) -> None:
        with self._cond:
            if not self._done:
                self._done = True
                self._failed = failed
                self._cond.notify_all()

    # -- importer side ---------------------------------------------------
    @property
    def failed(self) -> bool:
        with self._cond:
            return self._failed

    @property
    def done(self) -> bool:
        with self._cond:
            return self._done

    def frontier(self) -> int:
        with self._cond:
            return self._frontier

    def data_from_offset(self, offset: int) -> tuple[list, int]:
        with self._cond:
            return self._rows[offset:], len(self._rows)

    def snapshot(self, offset: int) -> tuple[list, int, int, bool, bool]:
        """(new rows, new offset, frontier, done, failed) — one lock hop."""
        with self._cond:
            return (
                self._rows[offset:],
                len(self._rows),
                self._frontier,
                self._done,
                self._failed,
            )

    def wait(self, offset: int, frontier: int, timeout: float) -> None:
        """Block until new rows/frontier/terminal state appear (or timeout)."""
        with self._cond:
            self._cond.wait_for(
                lambda: len(self._rows) > offset
                or self._frontier > frontier
                or self._done,
                timeout,
            )


class _ExportNode(df.OutputNode):
    """Sink feeding an ExportedTable; aborting runs mark it failed so a
    concurrent importer raises instead of waiting forever (the scopeguard
    in export.rs:143-146)."""

    name = "export"

    def __init__(self, scope, inp, exported: ExportedTable):
        super().__init__(
            scope,
            inp,
            on_data=exported._push,
            on_time_end=exported._advance,
            on_end=exported._finish,
        )
        self._exported = exported

    def on_abort(self):
        self._exported._finish(failed=True)


def export_table(table: Table) -> ExportedTable:
    r"""Register ``table`` for export from the CURRENT graph's next run.

    The handle fills while ``pw.run()`` executes and is complete once the
    run finishes; pass it to :func:`import_table` inside another graph
    (sequentially after ``G.clear()``, or on a concurrent run).
    Match: ``graph.rs:978`` ``export_table``.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('a | b\n1 | 2\n3 | 4')
    >>> exported = pw.export_table(t.select(s=pw.this.a + pw.this.b))
    >>> _ = pw.run()
    >>> exported.done
    True
    >>> pw.G.clear()  # a NEW graph imports the finished handle
    >>> imported = pw.import_table(exported)
    >>> pw.debug.compute_and_print(imported, include_id=False)
    s
    3
    7
    """
    exported = ExportedTable(table.schema)

    def attach(lowerer, node):
        return _ExportNode(lowerer.scope, node, exported)

    G.add_sink("export", table, attach)
    return exported


class _ImportPoller:
    """Runner poller draining an ExportedTable into an InputNode.

    Rows keep their original keys and times; the importing runner merges
    them into its own epoch sequence in order (InputNode staging), so
    epoch boundaries survive the hop exactly like the reference's
    ``input_session.update_at(key, time, diff)`` (export.rs:169-199).
    """

    def __init__(self, node: df.InputNode, exported: ExportedTable):
        self.node = node
        self.exported = exported
        self._offset = 0
        self._held: deque = deque()  # rows of epochs the exporter hasn't closed
        self.finished = False

    def poll(self) -> bool:
        if self.finished:
            return True
        rows, self._offset, frontier, done, failed = self.exported.snapshot(
            self._offset
        )
        if failed:
            raise ImportedTableFailed(
                "imported table's source graph failed before finishing"
            )
        # only stage rows from CLOSED exporter epochs (time <= frontier):
        # the importing runner treats any staged time as a complete epoch,
        # so releasing a half-pushed epoch would expose a partial state the
        # exporting graph never had
        self._held.extend(rows)
        while self._held and (done or self._held[0][2] <= frontier):
            key, row, time, diff = self._held.popleft()
            self.node.insert(key, row, time, diff)
        if done:
            self.node.close()
            self.finished = True
            return True
        return False


def import_table(exported: ExportedTable) -> Table:
    """A Table in the CURRENT graph backed by an :class:`ExportedTable`
    produced by another graph.  Match: ``graph.rs:984`` ``import_table``.
    """

    def build(lowerer) -> df.Node:
        node = df.InputNode(lowerer.scope)
        lowerer.pollers.append(_ImportPoller(node, exported))
        return node

    return Table(exported.schema, build, universe=Universe())

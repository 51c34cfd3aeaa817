"""Error-log tables (parity: dataflow.rs:582-673, pw.global_error_log).

With ``terminate_on_error=False`` the engine routes row-level failures into
an error log instead of raising; ``Value::Error`` poisons dependent cells
and ``remove_errors`` filters poisoned rows (same model as the reference).
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine import dataflow as df
from pathway_tpu_torch.engine.types import sequential_key
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Lowerer, Table, Universe

_ERROR_LOG_SCHEMA = schema_mod.schema_from_columns(
    {
        "operator_id": schema_mod.ColumnSchema(name="operator_id", dtype=dt.INT),
        "message": schema_mod.ColumnSchema(name="message", dtype=dt.STR),
    }
)


class _ErrorLogNode(df.InputNode):
    """Fed by the scope's error channel at epoch boundaries."""

    name = "error_log"

    def __init__(self, scope: df.Scope):
        super().__init__(scope)
        self.finished = True
        self._drained = 0

    def _drain(self, time):
        log = self.scope.error_log
        out = []
        for node, key, message in log[self._drained :]:
            k = sequential_key(self._drained)
            out.append((k, (node.id if node is not None else -1, message), 1))
            self._drained += 1
        self.send(out, time)

    def step(self, time):
        pass

    def flush(self, time):
        # errors surface at the epoch BOUNDARY: draining in step() would
        # miss failures from nodes that run later in the same epoch (the
        # downstream delivery then happens in the finish quiesce)
        self._drain(time)

    def on_finish(self):
        self._drain(self.scope.current_time)


_global_log_table: Table | None = None


def global_error_log() -> Table:
    global _global_log_table
    if _global_log_table is None:

        def build(lowerer: Lowerer) -> df.Node:
            return _ErrorLogNode(lowerer.scope)

        _global_log_table = Table(_ERROR_LOG_SCHEMA, build, universe=Universe())
    return _global_log_table


class local_error_log:
    """Context manager scoping an error log (parity: pw.local_error_log)."""

    def __enter__(self) -> Table:
        def build(lowerer: Lowerer) -> df.Node:
            return _ErrorLogNode(lowerer.scope)

        self._table = Table(_ERROR_LOG_SCHEMA, build, universe=Universe())
        return self._table

    def __exit__(self, *exc) -> None:
        return None

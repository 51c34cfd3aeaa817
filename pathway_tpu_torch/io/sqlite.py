"""SQLite connector (parity: python/pathway/io/sqlite; SqliteReader
data_storage.rs:1499).

Static snapshot read plus polling for changes by rowid/data hash (the
reference tails SQLite's data-version + table scan similarly).
"""

from __future__ import annotations

import sqlite3
import time as _time
from typing import Any

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._utils import COMMIT, DELETE, Reader


class _SqliteReader(Reader):
    def __init__(self, path: str, table_name: str, schema, streaming: bool, poll_interval: float = 0.5):
        self.path = path
        self.table_name = table_name
        self.schema = schema
        self.streaming = streaming
        self.poll_interval = poll_interval

    def run(self, emit) -> None:
        names = list(self.schema.__columns__.keys())
        cols = ", ".join(names)
        seen: dict[int, tuple] = {}
        while True:
            conn = sqlite3.connect(self.path)
            try:
                rows = conn.execute(
                    f"SELECT rowid, {cols} FROM {self.table_name}"  # noqa: S608
                ).fetchall()
            finally:
                conn.close()
            current = {r[0]: tuple(r[1:]) for r in rows}
            changed = False
            for rowid, values in current.items():
                if seen.get(rowid) != values:
                    if rowid in seen:
                        old = dict(zip(names, seen[rowid]))
                        old[DELETE] = True
                        old["_pw_key"] = ("sqlite", self.table_name, rowid)
                        emit(old)
                    row = dict(zip(names, values))
                    row["_pw_key"] = ("sqlite", self.table_name, rowid)
                    emit(row)
                    changed = True
            for rowid in list(seen):
                if rowid not in current:
                    old = dict(zip(names, seen[rowid]))
                    old[DELETE] = True
                    old["_pw_key"] = ("sqlite", self.table_name, rowid)
                    emit(old)
                    changed = True
            seen = current
            if changed:
                emit(COMMIT)
            if not self.streaming:
                return
            _time.sleep(self.poll_interval)


def read(
    path: str,
    table_name: str,
    schema: type[schema_mod.Schema],
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    debug_data: Any = None,
    **kwargs: Any,
) -> Table:
    from pathway_tpu_torch.io._file_readers import only_mode

    streaming = only_mode(mode)
    return _utils.make_input_table(
        schema,
        lambda: _SqliteReader(path, table_name, schema, streaming),
        autocommit_duration_ms=autocommit_duration_ms,
        debug_data=debug_data,
    )

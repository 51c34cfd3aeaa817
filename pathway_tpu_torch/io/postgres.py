"""PostgreSQL sink connector (parity: python/pathway/io/postgres;
engine PsqlWriter ``data_storage.rs:1025`` + formatters
``data_format.rs:1712`` PsqlUpdates / ``:1771`` PsqlSnapshot).

Speaks the v3 wire protocol directly (``io/_pgwire.py``) — no psycopg
needed.  ``write`` appends the change stream (rows + time/diff columns);
``write_snapshot`` maintains the current table state by primary key
(INSERT ... ON CONFLICT DO UPDATE / DELETE).  Each engine epoch commits as
one transaction, the reference's per-time batching.
"""

from __future__ import annotations

import threading
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._pgwire import PgConnection, quote_ident, quote_literal

_PG_TYPES = {
    dt.INT: "BIGINT",
    dt.FLOAT: "DOUBLE PRECISION",
    dt.BOOL: "BOOLEAN",
    dt.STR: "TEXT",
    dt.BYTES: "BYTEA",
    dt.DATE_TIME_NAIVE: "TIMESTAMP",
    dt.DATE_TIME_UTC: "TIMESTAMPTZ",
    dt.DURATION: "INTERVAL",
    dt.JSON: "JSONB",
}


def _pg_type(d: dt.DType) -> str:
    return _PG_TYPES.get(d.strip_optional() if hasattr(d, "strip_optional") else d, "TEXT")


def _connect(settings: dict) -> PgConnection:
    return PgConnection(
        host=settings.get("host", "localhost"),
        port=int(settings.get("port", 5432)),
        user=settings.get("user", "postgres"),
        password=settings.get("password", ""),
        dbname=settings.get("dbname", settings.get("database", "postgres")),
        connect_timeout=float(settings.get("connect_timeout", 10.0)),
    )


class _PgSink:
    """Shared epoch-transaction machinery for both writers."""

    def __init__(self, settings: dict, max_batch_size: int | None):
        self.settings = settings
        self.max_batch_size = max_batch_size
        self._conn: PgConnection | None = None
        self._batch: list[str] = []
        self._lock = threading.Lock()

    def conn(self) -> PgConnection:
        if self._conn is None:
            self._conn = _connect(self.settings)
        return self._conn

    def add(self, sql: str) -> None:
        with self._lock:
            self._batch.append(sql)
            if self.max_batch_size and len(self._batch) >= self.max_batch_size:
                self._flush_locked()

    def flush(self, _time: int | None = None) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._batch:
            return
        conn = self.conn()
        conn.execute("BEGIN")
        try:
            for s in self._batch:
                conn.execute(s)
            conn.execute("COMMIT")
        except Exception:
            # surface the statement error, not a possibly-dead connection's
            # ROLLBACK failure; keep the batch so a retried flush can resend
            try:
                conn.execute("ROLLBACK")
            except Exception:
                self._conn = None  # connection unusable — reconnect on retry
            raise
        self._batch = []

    def close(self) -> None:
        self.flush()
        if self._conn is not None:
            self._conn.close()
            self._conn = None


def _init_table(
    sink: _PgSink,
    table: Table,
    table_name: str,
    init_mode: str,
    extra_cols: list[tuple[str, str]],
    primary_key: list[str] | None = None,
) -> None:
    if init_mode == "default":
        return
    cols = [
        f"{quote_ident(n)} {_pg_type(table.schema.__columns__[n].dtype)}"
        for n in table.column_names()
    ] + [f"{quote_ident(n)} {t}" for n, t in extra_cols]
    if primary_key:
        cols.append(
            "PRIMARY KEY (" + ", ".join(quote_ident(c) for c in primary_key) + ")"
        )
    ddl = f"CREATE TABLE IF NOT EXISTS {quote_ident(table_name)} ({', '.join(cols)})"
    conn = sink.conn()
    if init_mode == "replace":
        conn.execute(f"DROP TABLE IF EXISTS {quote_ident(table_name)}")
    elif init_mode != "create_if_not_exists":
        raise ValueError(f"unknown init_mode {init_mode!r}")
    conn.execute(ddl)


def write(
    table: Table,
    postgres_settings: dict,
    table_name: str,
    *,
    max_batch_size: int | None = None,
    init_mode: str = "default",
    name: str | None = None,
    _sink_factory: Any = None,
) -> None:
    """Append the change stream: row columns + ``time`` and ``diff``.

    Mirrors PsqlUpdatesFormatter (``data_format.rs:1712``).
    """
    names = table.column_names()
    sink = (_sink_factory or _PgSink)(postgres_settings, max_batch_size)
    _init_table(
        sink, table, table_name, init_mode, [("time", "BIGINT"), ("diff", "BIGINT")]
    )
    collist = ", ".join(quote_ident(n) for n in names + ["time", "diff"])

    def on_data(key, row, time, diff):
        vals = ", ".join(quote_literal(v) for v in row) + f", {time}, {diff}"
        sink.add(f"INSERT INTO {quote_ident(table_name)} ({collist}) VALUES ({vals})")

    _utils.register_output(
        table,
        on_data,
        on_time_end=sink.flush,
        on_end=sink.close,
        name=name or f"postgres:{table_name}",
    )


def write_snapshot(
    table: Table,
    postgres_settings: dict,
    table_name: str,
    primary_key: list[str],
    *,
    max_batch_size: int | None = None,
    init_mode: str = "default",
    name: str | None = None,
    _sink_factory: Any = None,
) -> None:
    """Maintain the current state keyed by ``primary_key``.

    Mirrors PsqlSnapshotFormatter (``data_format.rs:1771``): upsert on
    insert, delete on retraction.
    """
    names = table.column_names()
    for c in primary_key:
        if c not in names:
            raise ValueError(f"primary key column {c!r} not in table")
    sink = (_sink_factory or _PgSink)(postgres_settings, max_batch_size)
    _init_table(sink, table, table_name, init_mode, [], primary_key=primary_key)
    collist = ", ".join(quote_ident(n) for n in names)
    pk_list = ", ".join(quote_ident(c) for c in primary_key)
    non_pk = [n for n in names if n not in primary_key]

    def on_data(key, row, time, diff):
        by_name = dict(zip(names, row))
        if diff > 0:
            vals = ", ".join(quote_literal(by_name[n]) for n in names)
            if non_pk:
                sets = ", ".join(
                    f"{quote_ident(n)} = EXCLUDED.{quote_ident(n)}" for n in non_pk
                )
                conflict = f"ON CONFLICT ({pk_list}) DO UPDATE SET {sets}"
            else:
                conflict = f"ON CONFLICT ({pk_list}) DO NOTHING"
            sink.add(
                f"INSERT INTO {quote_ident(table_name)} ({collist}) "
                f"VALUES ({vals}) {conflict}"
            )
        else:
            cond = " AND ".join(
                f"{quote_ident(c)} = {quote_literal(by_name[c])}" for c in primary_key
            )
            sink.add(f"DELETE FROM {quote_ident(table_name)} WHERE {cond}")

    _utils.register_output(
        table,
        on_data,
        on_time_end=sink.flush,
        on_end=sink.close,
        name=name or f"postgres:{table_name}",
    )

"""Delta Lake table connector (parity: python/pathway/io/deltalake;
engine ``DeltaTableReader`` ``src/connectors/data_lake/delta.rs:233`` and
``LakeWriter`` ``data_lake/writer.rs:32``).

Implements the open Delta protocol directly over ``pyarrow.parquet`` (in
the image) and the JSON transaction log — no ``deltalake`` package:

* **write**: appends the change stream (row columns + ``time``/``diff``)
  as parquet part files, committing one numbered ``_delta_log`` entry per
  flush (protocol/metaData actions at version 0, ``add`` actions after) —
  the LakeWriter's append-only layout.
* **read**: replays the transaction log (add/remove actions → live files),
  reads the parquet parts, and in streaming mode polls for new versions.
  A ``diff`` column of -1 in the stored data is interpreted as a
  retraction, so a table written by ``write`` round-trips through ``read``
  with its exact change-stream semantics.
"""

from __future__ import annotations

import json as _json
import os
import threading
import time as _time
import uuid
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._utils import COMMIT, DELETE, Offset, Reader

__all__ = ["read", "write"]

_SPARK_TYPES = {
    dt.INT: "long",
    dt.FLOAT: "double",
    dt.BOOL: "boolean",
    dt.STR: "string",
    dt.BYTES: "binary",
    dt.DATE_TIME_UTC: "timestamp",
    dt.DATE_TIME_NAIVE: "timestamp_ntz",
}


def _spark_type(d) -> str:
    base = d.strip_optional() if hasattr(d, "strip_optional") else d
    return _SPARK_TYPES.get(base, "string")


def _log_dir(uri: str) -> str:
    return os.path.join(uri, "_delta_log")


def _version_path(uri: str, version: int) -> str:
    return os.path.join(_log_dir(uri), f"{version:020d}.json")


def _list_versions(uri: str) -> list[int]:
    d = _log_dir(uri)
    if not os.path.isdir(d):
        return []
    out = []
    for f in os.listdir(d):
        if f.endswith(".json") and not f.endswith(".tmp"):
            try:
                out.append(int(f[:-5]))
            except ValueError:
                continue
    return sorted(out)


class _DeltaSink:
    def __init__(self, uri: str, table: Table, min_commit_frequency: int | None = None):
        # milliseconds between delta commits (None = every epoch flush):
        # bounds the version count a high-epoch-rate stream produces
        self._throttle = _utils.CommitThrottle(min_commit_frequency)
        self.uri = uri
        reserved = {"time", "diff", "_pw_key"} & set(table.column_names())
        if reserved:
            raise ValueError(
                f"deltalake.write: column names {sorted(reserved)} collide "
                "with the appended change-stream columns; rename them"
            )
        self.names = table.column_names() + ["time", "diff", "_pw_key"]
        self._schema_fields = [
            {
                "name": n,
                "type": _spark_type(table.schema.__columns__[n].dtype),
                "nullable": True,
                "metadata": {},
            }
            for n in table.column_names()
        ] + [
            {"name": "time", "type": "long", "nullable": False, "metadata": {}},
            {"name": "diff", "type": "long", "nullable": False, "metadata": {}},
            # engine row identity (hex): retractions in the stored change
            # stream must cancel the exact rows they retract on read-back
            {"name": "_pw_key", "type": "string", "nullable": False, "metadata": {}},
        ]
        self._rows: list[tuple] = []
        self._lock = threading.Lock()
        # engine row keys restart per (non-persisted) run: salting the
        # stored identity keeps independent runs' inserts distinct.  With
        # persistence the keys ARE stable across resumes, so the salt must
        # be too — it derives from the persistence root when one is active
        # (lazily: the root is known only once pw.run starts)
        self._run_id: str | None = None
        self._version: int | None = None

    def _ensure_table(self) -> None:
        if self._version is not None:
            return
        versions = _list_versions(self.uri)
        if versions:
            self._version = versions[-1]
            return
        os.makedirs(_log_dir(self.uri), exist_ok=True)
        actions = [
            {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
            {
                "metaData": {
                    "id": str(uuid.uuid4()),
                    "format": {"provider": "parquet", "options": {}},
                    "schemaString": _json.dumps(
                        {"type": "struct", "fields": self._schema_fields}
                    ),
                    "partitionColumns": [],
                    "configuration": {},
                    "createdTime": int(_time.time() * 1000),
                }
            },
        ]
        tmp = self._write_tmp(actions)
        try:
            if self._claim(tmp, _version_path(self.uri, 0)):
                self._version = 0
            else:
                # another worker created the table first — adopt its
                # metadata; committing our own metaData action would REPLACE
                # the table id for spec-conforming readers
                self._version = max(_list_versions(self.uri))
        finally:
            os.unlink(tmp)

    def _write_tmp(self, actions: list[dict]) -> str:
        tmp = os.path.join(_log_dir(self.uri), f".{uuid.uuid4().hex}.tmp")
        with open(tmp, "w") as f:
            f.write("".join(_json.dumps(a) + "\n" for a in actions))
            f.flush()
            os.fsync(f.fileno())
        return tmp

    @staticmethod
    def _claim(tmp: str, path: str) -> bool:
        """Atomically publish tmp as path iff path does not exist yet —
        hardlink gives create-if-absent AND full-content visibility (readers
        never observe a half-written log entry)."""
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False

    def _commit(self, version: int, actions: list[dict]) -> int:
        """Claim the next free version for these actions."""
        tmp = self._write_tmp(actions)
        try:
            while not self._claim(tmp, _version_path(self.uri, version)):
                version += 1
            return version
        finally:
            os.unlink(tmp)

    def run_salt(self) -> str:
        if self._run_id is None:
            import hashlib

            from pathway_tpu_torch.engine.persistence import active_root

            root = active_root()
            self._run_id = (
                hashlib.md5(root.encode()).hexdigest()[:8]
                if root
                else uuid.uuid4().hex[:8]
            )
        return self._run_id

    def add(self, row: tuple) -> None:
        with self._lock:
            self._rows.append(row)

    def flush(self, _time_arg: int | None = None, *, force: bool = False) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        with self._lock:
            if not self._rows:
                return
            if not self._throttle.ready(force):
                return  # hold rows until the commit interval elapses
            rows, self._rows = self._rows, []
        self._ensure_table()
        cols = {n: [r[i] for r in rows] for i, n in enumerate(self.names)}
        part = f"part-{self._version + 1:05d}-{uuid.uuid4().hex[:12]}.parquet"
        full = os.path.join(self.uri, part)
        pq.write_table(pa.table(cols), full)
        self._version = self._commit(
            self._version + 1,
            [
                {
                    "add": {
                        "path": part,
                        "size": os.path.getsize(full),
                        "partitionValues": {},
                        "modificationTime": int(_time.time() * 1000),
                        "dataChange": True,
                    }
                }
            ],
        )


def write(
    table: Table,
    uri: str,
    *,
    min_commit_frequency: int | None = None,
    s3_connection_settings: Any = None,
    name: str | None = None,
    _sink_factory: Any = None,
) -> None:
    """Append the change stream to a Delta table at ``uri``."""
    if s3_connection_settings is not None:
        raise NotImplementedError(
            "deltalake.write: S3-backed Delta logs are not supported in "
            "this build; write to a local path and sync"
        )
    sink = (_sink_factory or _DeltaSink)(uri, table, min_commit_frequency)

    def on_data(key, row, time, diff):
        plain = tuple(
            v if isinstance(v, bytes) else _utils.plain_value(v) for v in row
        )
        sink.add(plain + (time, diff, f"{sink.run_salt()}:{key:032x}"))

    _utils.register_output(
        table,
        on_data,
        on_time_end=sink.flush,
        # end of stream always commits, regardless of min_commit_frequency
        on_end=lambda: sink.flush(force=True),
        name=name or f"deltalake:{uri}",
    )


class DeltaReadError(RuntimeError):
    pass


class _DeltaReader(Reader):
    supports_offsets = True

    def __init__(
        self,
        uri: str,
        schema,
        mode: str,
        poll_interval_s: float = 2.0,
        start_from_timestamp_ms: int | None = None,
    ):
        self.uri = uri
        self.schema = schema
        self.mode = mode
        self.poll_interval_s = poll_interval_s
        self.start_from_timestamp_ms = start_from_timestamp_ms
        self._applied_version = -1
        # names of parts this reader emitted live (streaming): a remove of a
        # file that was vacuumed before we could re-read it is unrecoverable
        # and must error, not silently skip.  Persisted with the offset so a
        # resumed reader keeps the same guarantee.
        self._emitted_parts: set[str] = set()
        self._gap_polls = 0  # consecutive polls the SAME gap persisted
        self._gap_at: int | None = None  # expected version at the gap

    def seek(self, offset: Any) -> None:
        self._applied_version = int(offset.get("version", -1))
        self._emitted_parts = set(offset.get("emitted", []))

    def _offset(self) -> Offset:
        return Offset(
            {
                "version": self._applied_version,
                "emitted": sorted(self._emitted_parts),
            }
        )

    def _read_rows(self, part: str, names, has_diff_col) -> list[dict]:
        import pyarrow.parquet as pq

        rows = []
        for rec in pq.read_table(os.path.join(self.uri, part)).to_pylist():
            row = {n: rec.get(n) for n in names}
            stored_key = rec.get("_pw_key")
            if stored_key is not None and "_pw_key" not in names:
                # retractions must land on the same engine key as the rows
                # they cancel; opaque string keys are hashed by ingestion
                row["_pw_key"] = stored_key
            # change-stream tables: a stored diff of -1 is a retraction
            # unless the user asked for the raw diff column
            if not has_diff_col and rec.get("diff", 1) < 0:
                row[DELETE] = True
            rows.append(row)
        return rows

    @staticmethod
    def _invert(row: dict) -> dict:
        out = dict(row)
        if out.pop(DELETE, False):
            return out  # retraction removed = the row comes back
        out[DELETE] = True
        return out

    def _checkpoint_files(self, version: int, parts: int | None) -> list[str]:
        log = _log_dir(self.uri)
        if not parts:
            return [os.path.join(log, f"{version:020d}.checkpoint.parquet")]
        return [
            os.path.join(
                log, f"{version:020d}.checkpoint.{i + 1:010d}.{parts:010d}.parquet"
            )
            for i in range(parts)
        ]

    def _load_checkpoint(self, names, has_diff_col, emit) -> None:
        """Foreign tables compact old log entries into parquet checkpoints
        (`_last_checkpoint` → checkpoint parquet part(s), holding the
        reconciled live add set); expired JSON versions are deleted, so a
        reader that only replays JSON would silently miss pre-checkpoint
        rows.  Cold start only: a resumed reader already replayed versions
        <= its offset from the persistence snapshot, and re-emitting the
        checkpoint's live set would duplicate them."""
        import pyarrow.parquet as pq

        marker = os.path.join(_log_dir(self.uri), "_last_checkpoint")
        if not os.path.exists(marker) or self._applied_version >= 0:
            return
        with open(marker) as f:
            info = _json.loads(f.read())
        version = int(info["version"])
        for cp in self._checkpoint_files(version, info.get("parts")):
            for rec in pq.read_table(cp).to_pylist():
                add = rec.get("add")
                if add and add.get("path"):
                    for row in self._read_rows(add["path"], names, has_diff_col):
                        emit(row)
        self._applied_version = version
        emit(self._offset())
        emit(COMMIT)

    def _parse_versions(
        self, versions: list[int]
    ) -> tuple[dict[int, list[dict]], dict[int, set[str]]]:
        """One parse per poll: version → actions, and version → paths
        removed by any STRICTLY LATER version in the batch (a remove at or
        before an add never excuses that add's missing file)."""
        parsed = {}
        for v in versions:
            with open(_version_path(self.uri, v)) as f:
                parsed[v] = [_json.loads(line) for line in f if line.strip()]
        removed_after: dict[int, set[str]] = {}
        acc: set[str] = set()
        for v in sorted(versions, reverse=True):
            removed_after[v] = set(acc)
            for a in parsed[v]:
                if a.get("remove"):
                    acc.add(a["remove"]["path"])
        return parsed, removed_after

    def _seek_to_timestamp(self) -> None:
        """start_from_timestamp_ms: consume-without-emitting every version
        whose commit timestamp precedes the cutoff (the reference's
        changes-after-timestamp streaming semantics, data_lake/delta.rs
        start_from_timestamp_ms)."""
        if self.start_from_timestamp_ms is None or self._applied_version >= 0:
            return
        last_before = -1
        for v in _list_versions(self.uri):
            ts = None
            try:
                with open(_log_path(self.uri, v)) as f:
                    for line in f:
                        action = _json.loads(line)
                        info = action.get("commitInfo")
                        if info is not None:
                            ts = info.get("timestamp")
                            break
            except OSError:
                break
            if ts is not None and ts >= self.start_from_timestamp_ms:
                break
            last_before = v
        self._applied_version = last_before

    def run(self, emit) -> None:
        names = list(self.schema.__columns__.keys())
        has_diff_col = "diff" in names
        self._seek_to_timestamp()
        self._load_checkpoint(names, has_diff_col, emit)
        while True:
            versions = [
                v for v in _list_versions(self.uri) if v > self._applied_version
            ]
            if versions and self._applied_version == -1 and versions[0] != 0:
                # cold start with a truncated log and no checkpoint: the
                # missing early versions' rows are unrecoverable
                raise DeltaReadError(
                    f"delta log starts at version {versions[0]} with no "
                    "checkpoint — earlier versions were expired; the table "
                    "cannot be read completely"
                )
            # a gap can be a transient listdir race with a concurrent
            # writer: process the contiguous prefix, re-poll, and only
            # raise if the same gap survives several polls (static mode has
            # no next poll, so it raises immediately below)
            contiguous = []
            expect = self._applied_version + 1 if self._applied_version >= 0 else None
            for v in versions:
                if expect is not None and v != expect:
                    break
                contiguous.append(v)
                expect = v + 1
            if len(contiguous) < len(versions):
                gap_at = (
                    contiguous[-1] + 1 if contiguous else self._applied_version + 1
                )
                if gap_at != self._gap_at:
                    # a different gap than last poll: the old one resolved
                    # (normal tip race with an active writer) — restart count
                    self._gap_at = gap_at
                    self._gap_polls = 1
                else:
                    self._gap_polls += 1
                if self.mode == "static" or self._gap_polls > 3:
                    nxt = versions[len(contiguous)]
                    raise DeltaReadError(
                        f"delta log gap: version "
                        f"{contiguous[-1] if contiguous else self._applied_version} "
                        f"is followed by {nxt} — intervening log entries are "
                        "missing (expired, or a commit that never completed)"
                    )
                versions = contiguous
            else:
                self._gap_polls = 0
                self._gap_at = None
            parsed, removed_after = self._parse_versions(versions)
            for version in versions:
                actions = parsed[version]
                removed_set = removed_after[version]
                for action in actions:
                    add = action.get("add")
                    removed = action.get("remove")
                    if add and add.get("dataChange", True):
                        part = add["path"]
                        if not os.path.exists(os.path.join(self.uri, part)):
                            # tolerable ONLY if a visible later version
                            # removes it (add+remove both skip → net zero);
                            # otherwise the table is missing data
                            if part in removed_set:
                                continue
                            raise DeltaReadError(
                                f"delta data file missing: {part} (version "
                                f"{version}) and no later remove action covers it"
                            )
                        for row in self._read_rows(part, names, has_diff_col):
                            emit(row)
                        if self.mode != "static":
                            self._emitted_parts.add(part)
                    elif removed and removed.get("dataChange", True):
                        part = removed["path"]
                        if os.path.exists(os.path.join(self.uri, part)):
                            # delta keeps removed files until vacuum (default
                            # retention days), so re-reading for the
                            # retraction is the normal path
                            for row in self._read_rows(part, names, has_diff_col):
                                emit(self._invert(row))
                            self._emitted_parts.discard(part)
                        elif part in self._emitted_parts:
                            raise DeltaReadError(
                                f"cannot retract {part}: its rows were "
                                "emitted but the file was vacuumed before "
                                "the remove could be replayed"
                            )
                        # else: cold replay of an already-vacuumed pair —
                        # its add was skipped too, net zero
                self._applied_version = version
                emit(self._offset())
                emit(COMMIT)
            if self.mode == "static":
                return
            _time.sleep(self.poll_interval_s)


def read(
    uri: str,
    *,
    schema: type[schema_mod.Schema] | None = None,
    mode: str = "streaming",
    start_from_timestamp_ms: int | None = None,
    s3_connection_settings: Any = None,
    autocommit_duration_ms: int | None = 1500,
    debug_data: Any = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    """Read a Delta table (static snapshot or streaming new versions).

    ``start_from_timestamp_ms`` emits only changes committed at/after the
    timestamp.  S3-backed tables are not reachable from this runtime —
    ``s3_connection_settings`` raises rather than silently reading nothing.
    """
    if s3_connection_settings is not None:
        raise NotImplementedError(
            "deltalake.read: S3-backed Delta logs are not supported in this "
            "build; sync the table to a local path first"
        )
    if schema is None:
        raise ValueError("deltalake.read requires schema=")
    return _utils.make_input_table(
        schema,
        lambda: _DeltaReader(
            uri, schema, mode, start_from_timestamp_ms=start_from_timestamp_ms
        ),
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        debug_data=debug_data,
    )

"""Apache Iceberg table connector (parity: python/pathway/io/iceberg;
engine ``IcebergReader`` ``src/connectors/data_lake/iceberg.rs:313`` and
the LakeWriter's Iceberg output).

Implements the open Iceberg v1 table format directly (HadoopCatalog-style
filesystem layout) — parquet data files, Avro manifest lists / manifests
(``io/_avro.py``), and versioned JSON table metadata with a
``version-hint.text`` pointer:

* **write**: appends the change stream (columns + ``time``/``diff``/
  ``_pw_key``); each flush commits one snapshot — a new parquet data
  file, a one-entry manifest, a full manifest list, and the next
  metadata version published atomically.
* **read**: replays snapshots in order (added manifests per snapshot),
  emits their data files' rows, and in streaming mode polls the version
  hint for new snapshots.  Stored ``diff=-1`` rows retract, so tables
  written by ``write`` round-trip exactly; ``status=2`` (DELETED)
  entries retract a removed file's rows.
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
from pathway_tpu_torch.io import _avro, _utils
from pathway_tpu_torch.io._utils import COMMIT, DELETE, Offset, Reader

__all__ = ["read", "write"]

_ICE_TYPES = {
    dt.INT: "long",
    dt.FLOAT: "double",
    dt.BOOL: "boolean",
    dt.STR: "string",
    dt.BYTES: "binary",
    dt.DATE_TIME_UTC: "timestamptz",
    dt.DATE_TIME_NAIVE: "timestamp",
}

# Avro schemas for the v1 metadata files (the subset every Iceberg reader
# of v1 tables understands; extra foreign fields decode generically)
_MANIFEST_FILE_SCHEMA = {
    "type": "record",
    "name": "manifest_file",
    "fields": [
        {"name": "manifest_path", "type": "string", "field-id": 500},
        {"name": "manifest_length", "type": "long", "field-id": 501},
        {"name": "partition_spec_id", "type": "int", "field-id": 502},
        {"name": "added_snapshot_id", "type": ["null", "long"], "default": None, "field-id": 503},
    ],
}

_DATA_FILE_SCHEMA = {
    "type": "record",
    "name": "r2",
    "fields": [
        {"name": "file_path", "type": "string", "field-id": 100},
        {"name": "file_format", "type": "string", "field-id": 101},
        {
            "name": "partition",
            "type": {"type": "record", "name": "r102", "fields": []},
            "field-id": 102,
        },
        {"name": "record_count", "type": "long", "field-id": 103},
        {"name": "file_size_in_bytes", "type": "long", "field-id": 104},
    ],
}

_MANIFEST_ENTRY_SCHEMA = {
    "type": "record",
    "name": "manifest_entry",
    "fields": [
        {"name": "status", "type": "int", "field-id": 0},
        {"name": "snapshot_id", "type": ["null", "long"], "default": None, "field-id": 1},
        {"name": "data_file", "type": _DATA_FILE_SCHEMA, "field-id": 2},
    ],
}

_ADDED, _EXISTING, _DELETED = 1, 0, 2


def _meta_dir(uri: str) -> str:
    return os.path.join(uri, "metadata")


def _current_metadata(uri: str) -> tuple[dict, int] | None:
    """(metadata, version) of the current table state, or None."""
    md = _meta_dir(uri)
    hint = os.path.join(md, "version-hint.text")
    version = None
    if os.path.exists(hint):
        with open(hint) as f:
            try:
                version = int(f.read().strip())
            except ValueError:
                version = None
    if version is None:
        if not os.path.isdir(md):
            return None
        versions = [
            int(f[1:].split(".")[0])
            for f in os.listdir(md)
            if f.startswith("v") and f.endswith(".metadata.json")
        ]
        if not versions:
            return None
        version = max(versions)
    path = os.path.join(md, f"v{version}.metadata.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return _json.load(f), version


class _IcebergSink:
    def __init__(self, uri: str, table: Table, min_commit_frequency: int | None = None):
        # milliseconds between commits (None = every epoch flush)
        self._throttle = _utils.CommitThrottle(min_commit_frequency)
        self.uri = uri
        reserved = {"time", "diff", "_pw_key"} & set(table.column_names())
        if reserved:
            raise ValueError(
                f"iceberg.write: column names {sorted(reserved)} collide "
                "with the appended change-stream columns; rename them"
            )
        self.names = table.column_names() + ["time", "diff", "_pw_key"]
        self._fields = [
            {
                "id": i + 1,
                "name": n,
                "required": False,
                "type": _ICE_TYPES.get(
                    table.schema.__columns__[n].dtype.strip_optional()
                    if hasattr(table.schema.__columns__[n].dtype, "strip_optional")
                    else table.schema.__columns__[n].dtype,
                    "string",
                ),
            }
            for i, n in enumerate(table.column_names())
        ] + [
            {"id": len(table.column_names()) + 1, "name": "time", "required": True, "type": "long"},
            {"id": len(table.column_names()) + 2, "name": "diff", "required": True, "type": "long"},
            {"id": len(table.column_names()) + 3, "name": "_pw_key", "required": True, "type": "string"},
        ]
        self._rows: list[tuple] = []
        self._lock = threading.Lock()
        # engine row keys restart per (non-persisted) run: salting the
        # stored identity keeps independent runs' inserts distinct.  With
        # persistence the keys ARE stable across resumes, so the salt must
        # be too — it derives from the persistence root when one is active
        # (lazily: the root is known only once pw.run starts)
        self._run_id: str | None = None
        self._manifests: list[dict] | None = None  # loaded lazily
        self._version: int | None = None
        self._table_uuid: str | None = None
        self._snapshots: list[dict] = []

    def _load_state(self) -> None:
        if self._version is not None:
            return
        current = _current_metadata(self.uri)
        if current is None:
            os.makedirs(_meta_dir(self.uri), exist_ok=True)
            os.makedirs(os.path.join(self.uri, "data"), exist_ok=True)
            self._version = 0
            self._table_uuid = str(uuid.uuid4())
            self._manifests = []
            self._snapshots = []
            return
        meta, version = current
        self._version = version
        self._table_uuid = meta.get("table-uuid", str(uuid.uuid4()))
        self._snapshots = list(meta.get("snapshots", []))
        self._manifests = []
        cur_id = meta.get("current-snapshot-id")
        for snap in self._snapshots:
            if snap.get("snapshot-id") == cur_id:
                ml = snap["manifest-list"]
                self._manifests = _avro.read_container(
                    ml if os.path.isabs(ml) else os.path.join(self.uri, ml)
                )
        os.makedirs(os.path.join(self.uri, "data"), exist_ok=True)

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
                return
            rows, self._rows = self._rows, []
        self._load_state()
        snapshot_id = int(_time.time() * 1000) * 1000 + (self._version or 0) % 1000

        part = f"data/part-{uuid.uuid4().hex[:16]}.parquet"
        full = os.path.join(self.uri, part)
        cols = {n: [r[i] for r in rows] for i, n in enumerate(self.names)}
        pq.write_table(pa.table(cols), full)

        manifest_name = f"metadata/manifest-{uuid.uuid4().hex[:16]}.avro"
        _avro.write_container(
            os.path.join(self.uri, manifest_name),
            _MANIFEST_ENTRY_SCHEMA,
            [
                {
                    "status": _ADDED,
                    "snapshot_id": snapshot_id,
                    "data_file": {
                        "file_path": part,
                        "file_format": "PARQUET",
                        "partition": {},
                        "record_count": len(rows),
                        "file_size_in_bytes": os.path.getsize(full),
                    },
                }
            ],
        )
        self._manifests.append(
            {
                "manifest_path": manifest_name,
                "manifest_length": os.path.getsize(
                    os.path.join(self.uri, manifest_name)
                ),
                "partition_spec_id": 0,
                "added_snapshot_id": snapshot_id,
            }
        )
        list_name = f"metadata/snap-{snapshot_id}.avro"
        _avro.write_container(
            os.path.join(self.uri, list_name), _MANIFEST_FILE_SCHEMA, self._manifests
        )
        self._snapshots.append(
            {
                "snapshot-id": snapshot_id,
                "timestamp-ms": int(_time.time() * 1000),
                "summary": {"operation": "append"},
                "manifest-list": list_name,
            }
        )
        new_version = self._version + 1
        metadata = {
            "format-version": 1,
            "table-uuid": self._table_uuid,
            "location": self.uri,
            "last-updated-ms": int(_time.time() * 1000),
            "last-column-id": len(self._fields),
            "schema": {"type": "struct", "fields": self._fields},
            "partition-spec": [],
            "partition-specs": [{"spec-id": 0, "fields": []}],
            "default-spec-id": 0,
            "properties": {},
            "current-snapshot-id": snapshot_id,
            "snapshots": self._snapshots,
        }
        md = _meta_dir(self.uri)
        meta_path = os.path.join(md, f"v{new_version}.metadata.json")
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as f:
            _json.dump(metadata, f)
        os.replace(tmp, meta_path)
        hint_tmp = os.path.join(md, "version-hint.text.tmp")
        with open(hint_tmp, "w") as f:
            f.write(str(new_version))
        os.replace(hint_tmp, os.path.join(md, "version-hint.text"))
        self._version = new_version


def write(
    table: Table,
    catalog_uri: str | None = None,
    namespace: list[str] | None = None,
    table_name: str | None = None,
    *,
    warehouse: str | None = None,
    min_commit_frequency: int | None = None,
    uri: str | None = None,
    name: str | None = None,
    _sink_factory: Any = None,
) -> None:
    """Append the change stream to an Iceberg table.

    ``uri`` points at the table directory (HadoopCatalog layout); the
    reference's catalog arguments are accepted for API parity and derive a
    path when ``uri`` is not given.
    """
    if uri is None:
        root = warehouse or catalog_uri
        if root is None or table_name is None:
            raise ValueError("provide uri= (table directory) or catalog args")
        uri = os.path.join(root, *(namespace or []), table_name)
    sink = (_sink_factory or _IcebergSink)(uri, table, min_commit_frequency)

    def on_data(key, row, time, diff):
        plain = tuple(
            v if isinstance(v, bytes) else _utils.plain_value(v) for v in row
        )
        sink.add(plain + (time, diff, f"{sink.run_salt()}:{key:032x}"))

    _utils.register_output(
        table,
        on_data,
        on_time_end=sink.flush,
        on_end=lambda: sink.flush(force=True),
        name=name or f"iceberg:{uri}",
    )


class IcebergReadError(RuntimeError):
    pass


class _IcebergReader(Reader):
    supports_offsets = True

    def __init__(self, uri: str, schema, mode: str, poll_interval_s: float = 2.0):
        self.uri = uri
        self.schema = schema
        self.mode = mode
        self.poll_interval_s = poll_interval_s
        self._done_snapshots: set[int] = set()
        # manifests already replayed: snapshot expiration can leave
        # manifests whose added_snapshot_id no longer appears in the
        # metadata, so identity — not snapshot matching — decides novelty
        self._done_manifests: set[str] = set()

    def seek(self, offset: Any) -> None:
        self._done_snapshots = set(offset.get("snapshots", []))
        self._done_manifests = set(offset.get("manifests", []))

    def _offset(self) -> Offset:
        return Offset(
            {
                "snapshots": sorted(self._done_snapshots),
                "manifests": sorted(self._done_manifests),
            }
        )

    def _emit_data_file(self, data_file: dict, names, has_diff_col, emit, *, invert: bool) -> None:
        import pyarrow.parquet as pq

        path = data_file["file_path"]
        full = path if os.path.isabs(path) else os.path.join(self.uri, path)
        for rec in pq.read_table(full).to_pylist():
            row = {n: rec.get(n) for n in names}
            stored_key = rec.get("_pw_key")
            if stored_key is not None and "_pw_key" not in names:
                # opaque identity string; hashed into the key space by the
                # ingestion layer
                row["_pw_key"] = stored_key
            negative = (not has_diff_col and rec.get("diff", 1) < 0) != invert
            if negative:
                row[DELETE] = True
            emit(row)

    def run(self, emit) -> None:
        names = list(self.schema.__columns__.keys())
        has_diff_col = "diff" in names
        while True:
            current = _current_metadata(self.uri)
            changed = False
            if current is not None:
                meta, _version = current
                snapshots = sorted(
                    meta.get("snapshots", []), key=lambda s: s["snapshot-id"]
                )
                for snap in snapshots:
                    sid = snap["snapshot-id"]
                    if sid in self._done_snapshots:
                        continue
                    ml = snap["manifest-list"]
                    ml_path = ml if os.path.isabs(ml) else os.path.join(self.uri, ml)
                    for mf in _avro.read_container(ml_path):
                        # incremental: every manifest not yet replayed
                        # (covers manifests inherited from expired
                        # snapshots, whose ids are no longer listed)
                        if mf["manifest_path"] in self._done_manifests:
                            continue
                        self._done_manifests.add(mf["manifest_path"])
                        mpath = mf["manifest_path"]
                        mpath = (
                            mpath
                            if os.path.isabs(mpath)
                            else os.path.join(self.uri, mpath)
                        )
                        for entry in _avro.read_container(mpath):
                            status = entry.get("status", _ADDED)
                            if status == _EXISTING:
                                continue  # carried over from a prior snapshot
                            self._emit_data_file(
                                entry["data_file"],
                                names,
                                has_diff_col,
                                emit,
                                invert=(status == _DELETED),
                            )
                    self._done_snapshots.add(sid)
                    changed = True
            if changed:
                emit(self._offset())
                emit(COMMIT)
            if self.mode == "static":
                return
            _time.sleep(self.poll_interval_s)


def read(
    catalog_uri: str | None = None,
    namespace: list[str] | None = None,
    table_name: str | None = None,
    *,
    warehouse: str | None = None,
    uri: str | None = None,
    schema: type[schema_mod.Schema] | None = None,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    debug_data: Any = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    """Read an Iceberg table (snapshot replay + streaming new snapshots)."""
    if schema is None:
        raise ValueError("iceberg.read requires schema=")
    if uri is None:
        root = warehouse or catalog_uri
        if root is None or table_name is None:
            raise ValueError("provide uri= (table directory) or catalog args")
        uri = os.path.join(root, *(namespace or []), table_name)
    return _utils.make_input_table(
        schema,
        lambda: _IcebergReader(uri, schema, mode),
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        debug_data=debug_data,
    )

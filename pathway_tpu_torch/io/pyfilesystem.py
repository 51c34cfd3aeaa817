"""Virtual-filesystem source connector (parity: python/pathway/io/pyfilesystem).

Reads objects from any filesystem abstraction: a PyFilesystem2 ``FS``
object (``walk.files``/``readbytes``), an fsspec filesystem (``find``/
``cat_file`` — fsspec ships in this image, covering memory://, zip, local,
and any installed remote protocols), or anything duck-typing either API.
Emits one row per object: path, raw bytes, and modification stamp.
"""

from __future__ import annotations

import time as _time
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._utils import COMMIT, Offset, Reader

__all__ = ["read"]


def _list_files(source: Any, path: str) -> list[str]:
    # detect by the reading API, not `walk`: fsspec also has a walk METHOD
    if hasattr(source, "readbytes"):  # PyFilesystem2
        return sorted(source.walk.files(path or "/"))
    if hasattr(source, "cat_file"):  # fsspec
        return sorted(source.find(path or ""))
    raise TypeError(
        "pyfilesystem source must expose walk.files/readbytes (PyFilesystem) "
        "or find/cat_file (fsspec)"
    )


def _read_bytes(source: Any, path: str) -> bytes:
    if hasattr(source, "readbytes"):
        return source.readbytes(path)
    if hasattr(source, "cat_file"):
        return source.cat_file(path)
    raise TypeError("source cannot read files")


def _modified(source: Any, path: str) -> str:
    """Change stamp for a file: mtime when the filesystem has one, else
    size — an empty constant stamp would make modified files invisible to
    the streaming re-read check forever."""
    size = ""
    try:
        if hasattr(source, "getinfo"):  # PyFilesystem2
            info = source.getinfo(path, namespaces=["details"])
            if info.modified is not None:
                return info.modified.isoformat()
            size = f"sz:{info.size}"
        elif hasattr(source, "info"):  # fsspec
            info = source.info(path)
            m = info.get("mtime") or info.get("LastModified") or info.get("created")
            if m is not None:
                return str(m)
            size = f"sz:{info.get('size', '')}"
    except Exception:
        pass
    return size


class _VfsReader(Reader):
    supports_offsets = True

    def __init__(
        self,
        source: Any,
        path: str,
        format: str,
        mode: str,
        refresh_interval: float,
        with_metadata: bool = False,
    ):
        self.source = source
        self.path = path
        self.format = format
        self.mode = mode
        self.refresh_interval = refresh_interval
        self.with_metadata = with_metadata
        self._done: dict[str, str] = {}  # path -> modified stamp

    def seek(self, offset: Any) -> None:
        self._done = dict(offset.get("files", {}))

    def _offset(self) -> Offset:
        return Offset({"files": dict(self._done)})

    def run(self, emit) -> None:
        from pathway_tpu_torch.io._utils import DELETE

        while True:
            seen = set()
            changed = False
            for p in _list_files(self.source, self.path):
                seen.add(p)
                stamp = _modified(self.source, p)
                if self._done.get(p) == stamp and p in self._done:
                    continue
                data = _read_bytes(self.source, p)
                if self.format != "binary":
                    data = data.decode("utf-8", errors="replace")
                # _pw_key = path: the input session runs in upsert mode, so
                # a re-read modified file REPLACES its previous row (the
                # engine retracts the old contents itself)
                row = {"data": data, "path": p, "modified_at": stamp, "_pw_key": p}
                if self.with_metadata:
                    from pathway_tpu_torch.engine.types import Json

                    row["_metadata"] = Json(
                        {"path": p, "modified_at": stamp, "size": len(data)}
                    )
                emit(row)
                self._done[p] = stamp
                changed = True
            # deleted files leave the table
            for gone in [p for p in self._done if p not in seen]:
                emit({"_pw_key": gone, DELETE: True, "path": gone})
                del self._done[gone]
                changed = True
            if changed:
                emit(self._offset())
                emit(COMMIT)
            if self.mode == "static":
                return
            _time.sleep(self.refresh_interval)


def read(
    source: Any,
    path: str = "",
    *,
    format: str = "binary",
    mode: str = "streaming",
    refresh_interval: float = 30.0,
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    """Read every object under ``path`` of a virtual filesystem.

    Reference: ``pw.io.pyfilesystem.read`` (python/pathway/io/pyfilesystem).
    """
    value_type = bytes if format == "binary" else str
    schema = schema_mod.schema_from_columns(
        {
            "data": schema_mod.ColumnSchema(name="data", dtype=dt.wrap(value_type)),
            "path": schema_mod.ColumnSchema(name="path", dtype=dt.STR),
            "modified_at": schema_mod.ColumnSchema(name="modified_at", dtype=dt.STR),
        }
    )
    if with_metadata:
        schema = _utils.with_metadata_schema(schema)
    return _utils.make_input_table(
        schema,
        lambda: _VfsReader(
            source, path, format, mode, refresh_interval, with_metadata
        ),
        autocommit_duration_ms=autocommit_duration_ms,
        upsert=True,  # modified objects replace their previous row
        name=name,
    )

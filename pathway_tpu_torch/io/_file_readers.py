"""Filesystem scanners/readers.

A copy of ``pathway_tpu/io/_file_readers.py`` (parity target:
``PosixLikeReader`` + filesystem scanner, ``src/connectors/posix_like.rs:39``,
``src/connectors/scanner/filesystem.rs``, and the format parsers of
``data_format.rs``: DsvParser:484, JsonLinesParser:1526,
IdentityParser:812).  Static mode reads the current snapshot; streaming
mode polls for new files and appended rows.

The persisted frontier is the JAX package's ``{path: [mtime, units]}``
(``seek`` and ``Offset``).  A file resumed from it is read on from its
consumed units in either mode, as in the JAX package.  Under several
workers each file belongs to one worker, by a stable hash of its path
(``partition``).

In streaming mode the port also takes back what a file no longer holds,
as the reference's scanner does: a deleted file retracts its rows, and a
file rewritten other than by appending retracts its old rows and inserts
its new ones.  The JAX package's reader emits nothing for either (a
rewrite past a whole-file format's first read is skipped, and a line
format's rewrite yields only the lines past the old line count).
"""

from __future__ import annotations

import csv as _csv
import glob as _glob
import hashlib
import json as _json
import os
import time as _time
from typing import Callable, Iterator

from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.io._utils import COMMIT, DELETE, FILE_ROW, Offset, RawRows, Reader


def _list_files(path: str, object_pattern: str = "*") -> list[str]:
    import fnmatch

    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            for f in sorted(files):
                # object_pattern filters by file NAME (reference
                # io/_utils.py object_pattern semantics)
                if fnmatch.fnmatch(f, object_pattern):
                    out.append(os.path.join(root, f))
        return sorted(out)
    matched = sorted(
        p for p in _glob.glob(path)
        if fnmatch.fnmatch(os.path.basename(p), object_pattern)
    )
    if matched:
        return matched
    if os.path.exists(path) and fnmatch.fnmatch(
        os.path.basename(path), object_pattern
    ):
        return [path]
    return []


def _path_owner(path: str, worker_count: int) -> int:
    """Stable worker assignment for a file (survives new files appearing)."""
    digest = hashlib.blake2b(path.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") % worker_count


def _metadata(path: str) -> Json:
    try:
        st = os.stat(path)
        return Json(
            {
                "path": os.path.abspath(path),
                "size": st.st_size,
                "modified_at": int(st.st_mtime),
                "seen_at": int(_time.time()),
                "owner": str(st.st_uid),
            }
        )
    except OSError:
        return Json({"path": os.path.abspath(path)})


def _digest_rows(digest, rows):
    """Feed parsed rows to ``digest`` by their ``repr``, each closed by a NUL
    (which a ``repr`` escapes)."""
    for row in rows:
        digest.update(repr(row).encode() + b"\0")
    return digest


class FileReader(Reader):
    """Scans `path`; parses each file with `parse_file`; optionally polls.

    Persistence: the offset frontier is the per-file progress map
    ``{path: [mtime, consumed_units]}`` (the role the offset antichain +
    cached object storage play for PosixLikeReader, posix_like.rs:39).
    """

    supports_offsets = True

    def __init__(
        self,
        path: str,
        parse_file: Callable[[str, int], tuple[Iterator[dict], int]],
        *,
        streaming: bool,
        poll_interval: float = 0.5,
        with_metadata: bool = False,
        object_pattern: str = "*",
    ):
        self.object_pattern = object_pattern
        self.path = path
        self.parse_file = parse_file
        self.streaming = streaming
        self.poll_interval = poll_interval
        self.with_metadata = with_metadata
        # per-file progress: (mtime, consumed_units)
        self._progress: dict[str, tuple[float, int]] = {}
        # streaming mode: per file, the count of rows emitted and a digest
        # of them, to tell an append from a rewrite; the poller keeps the
        # rows themselves, by their FILE_ROW tags
        self._emitted: dict[str, tuple[int, bytes]] = {}
        # files resumed from a persisted frontier (``seek``): this run
        # emitted none of their rows, so it can neither hold an append to
        # their digest nor take them back; they are read on from their
        # consumed units, as the JAX package's reader reads every file
        self._resumed: set[str] = set()
        # multi-worker file split: ownership is a stable hash of the file
        # path — NOT the listing index, which would reassign existing files
        # (and re-emit them) whenever a new file sorts in front of them
        self._stripe: tuple[int, int] | None = None

    def partition(self, worker_id: int, worker_count: int) -> "FileReader":
        self._stripe = (worker_id, worker_count)
        return self

    def _my_files(self) -> list[str]:
        files = _list_files(self.path, self.object_pattern)
        if self._stripe is None:
            return files
        wid, n = self._stripe
        return [f for f in files if _path_owner(f, n) == wid]

    def _emit_file(self, path: str, emit) -> bool:
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            return False
        prev = self._progress.get(path)
        offset = prev[1] if prev else 0
        if prev and prev[0] == mtime:
            return False
        if self.streaming and path not in self._resumed:
            return self._emit_streaming(path, mtime, emit)
        rows, new_offset = self.parse_file(path, offset)
        emitted = False
        meta = _metadata(path) if self.with_metadata else None
        for row in rows:
            if meta is not None:
                row.setdefault("_metadata", meta)
            emit(row)
            emitted = True
        self._progress[path] = (mtime, new_offset)
        return emitted

    def _emit_streaming(self, path: str, mtime: float, emit) -> bool:
        """Streaming mode: the file is parsed whole and its leading rows held
        to the digest of the rows emitted for it.  An append emits only the
        new rows; any other change retracts the old rows and emits all.
        Each row (dicts without metadata, or a bulk batch's value tuples)
        carries its ``FILE_ROW`` tag, and a bulk batch its tags, for a later
        retraction."""
        items, new_offset = self.parse_file(path, 0)
        rows: list = []
        for item in items:
            if isinstance(item, RawRows):
                rows.extend(item.rows)
            else:
                rows.append(item)
        n_old, old_digest = self._emitted.get(path, (0, None))
        digest = _digest_rows(hashlib.blake2b(digest_size=16), rows[:n_old])
        retracted = False
        if old_digest is None or (len(rows) >= n_old and digest.digest() == old_digest):
            new, first = rows[n_old:], n_old
        else:
            retracted = self._retract(path, emit)
            new, first, digest = rows, 0, hashlib.blake2b(digest_size=16)
        meta = _metadata(path) if self.with_metadata and new else None
        bulk: list = []
        tags: list = []
        for i, row in enumerate(new, start=first):
            if isinstance(row, tuple):  # values of a bulk batch
                bulk.append(row)
                tags.append((path, i))
                continue
            if bulk:
                emit(RawRows(bulk, tags))
                bulk, tags = [], []
            out = dict(row)
            if meta is not None:
                out.setdefault("_metadata", meta)
            out[FILE_ROW] = (path, i)
            emit(out)
        if bulk:
            emit(RawRows(bulk, tags))
        self._emitted[path] = (len(rows), _digest_rows(digest, new).digest())
        self._progress[path] = (mtime, new_offset)
        return bool(new) or retracted

    def _retract(self, path: str, emit) -> bool:
        """Take back every row emitted for ``path`` (streaming mode)."""
        n_rows, _digest = self._emitted.pop(path, (0, None))
        for i in range(n_rows):
            emit({FILE_ROW: (path, i), DELETE: True})
        return bool(n_rows)

    def seek(self, offset) -> None:
        self._progress = {
            path: (float(mtime), int(units)) for path, (mtime, units) in offset.items()
        }
        self._resumed = set(self._progress)

    def _offset(self) -> Offset:
        return Offset({p: [m, u] for p, (m, u) in self._progress.items()})

    def run(self, emit) -> None:
        while True:
            emitted = False
            files = self._my_files()
            for path in files:
                if self._emit_file(path, emit):
                    emitted = True
            if self.streaming:
                for path in sorted(set(self._emitted) - set(files)):
                    self._progress.pop(path, None)
                    if self._retract(path, emit):
                        emitted = True
            if emitted:
                emit(self._offset())
                emit(COMMIT)
            if not self.streaming:
                if not emitted:
                    emit(self._offset())
                return
            _time.sleep(self.poll_interval)


def csv_parse_file(csv_settings: dict | None = None):
    settings = csv_settings or {}

    def parse(path: str, offset: int):
        with open(path, newline="", encoding="utf-8", errors="replace") as f:
            reader = _csv.DictReader(f, **settings)
            rows = list(reader)

        def gen():
            for row in rows[offset:]:
                yield dict(row)

        return gen(), len(rows)

    return parse


def jsonlines_objects(path: str, offset: int):
    """Shared line scan for BOTH jsonlines paths (dict rows and the bulk
    RawRows path): yields parsed objects, skipping blank/malformed lines;
    the offset unit is raw line count."""
    with open(path, encoding="utf-8", errors="replace") as f:
        lines = f.readlines()

    def gen():
        for line in lines[offset:]:
            line = line.strip()
            if not line:
                continue
            try:
                yield _json.loads(line)
            except _json.JSONDecodeError:
                continue

    return gen(), len(lines)


def jsonlines_parse_file(path: str, offset: int):
    objs, new_offset = jsonlines_objects(path, offset)

    def gen():
        for obj in objs:
            yield {
                k: (Json(v) if isinstance(v, (dict, list)) else v)
                for k, v in obj.items()
            }

    return gen(), new_offset


def plaintext_parse_file(path: str, offset: int):
    with open(path, encoding="utf-8", errors="replace") as f:
        lines = f.readlines()

    def gen():
        for line in lines[offset:]:
            yield {"data": line.rstrip("\n")}

    return gen(), len(lines)


def plaintext_by_file_parse(path: str, offset: int):
    if offset > 0:
        return iter(()), 1
    with open(path, encoding="utf-8", errors="replace") as f:
        data = f.read()
    return iter([{"data": data}]), 1


def binary_parse_file(path: str, offset: int):
    if offset > 0:
        return iter(()), 1
    with open(path, "rb") as f:
        data = f.read()
    return iter([{"data": data}]), 1


def only_mode(mode: str) -> bool:
    if mode not in ("streaming", "static"):
        raise ValueError(f"unknown mode {mode!r}; use 'streaming' or 'static'")
    return mode == "streaming"

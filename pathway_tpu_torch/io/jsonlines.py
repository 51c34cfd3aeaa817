"""JSON Lines connector (parity: python/pathway/io/jsonlines)."""

from __future__ import annotations

import json as _json
import threading
from typing import Any

from pathway_tpu_torch.engine.types import Json, Pointer
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._file_readers import (
    FileReader,
    jsonlines_objects,
    jsonlines_parse_file,
    only_mode,
)


def read(
    path: str,
    *,
    schema: type[schema_mod.Schema] | None = None,
    mode: str = "streaming",
    json_field_paths: dict | None = None,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    with_metadata: bool = False,
    object_pattern: str = "*",
    debug_data: Any = None,
    **kwargs: Any,
) -> Table:
    r"""Read JSON Lines file(s) into a table (bulk-ingested when metadata is off).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> import os, tempfile
    >>> d = tempfile.mkdtemp()
    >>> with open(os.path.join(d, 'rows.jsonl'), 'w') as f:
    ...     _ = f.write('{"k": "a", "v": 1}\n{"k": "b", "v": 2}\n')
    >>> t = pw.io.jsonlines.read(d, schema=pw.schema_from_types(k=str, v=int), mode='static')
    >>> pw.debug.compute_and_print(t, include_id=False)
    k | v
    a | 1
    b | 2
    """
    if schema is None:
        raise ValueError("jsonlines.read requires schema=")
    names = list(schema.__columns__.keys())
    dtypes = {n: schema.__columns__[n].dtype for n in names}

    cols_spec = [
        (
            n,
            dtypes[n],
            json_field_paths.get(n) if json_field_paths else None,
        )
        for n in names
    ]

    def typed_parse(p, offset):
        if not with_metadata:
            # bulk path: parse + coerce straight into one RawRows batch,
            # skipping the per-row dict layers and per-row queue traffic.
            # The line scan (skip rules, line-count offsets) is shared with
            # the row path via jsonlines_objects.
            objs, new_offset = jsonlines_objects(p, offset)
            coerce = dt.coerce
            out_rows = []
            for obj in objs:
                vals = []
                for n, d, pth in cols_spec:
                    v = _extract_path(obj, pth) if pth else obj.get(n)
                    if isinstance(v, (dict, list)):
                        v = Json(v)
                    vals.append(coerce(_coerce_json(v, d), d))
                out_rows.append(tuple(vals))
            return [_utils.RawRows(out_rows)], new_offset

        rows, new_offset = jsonlines_parse_file(p, offset)

        def gen():
            for row in rows:
                out = {}
                for n in names:
                    if json_field_paths and n in json_field_paths:
                        v = _extract_path(row, json_field_paths[n])
                    else:
                        v = row.get(n)
                    out[n] = _coerce_json(v, dtypes[n])
                yield out

        return gen(), new_offset

    streaming = only_mode(mode)
    return _utils.make_input_table(
        schema,
        lambda: FileReader(
            path, typed_parse, streaming=streaming,
            with_metadata=with_metadata, object_pattern=object_pattern,
        ),
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        debug_data=debug_data,
    )


def _extract_path(row: dict, path: str):
    cur: Any = row
    for part in path.strip("/").split("/"):
        if isinstance(cur, Json):
            cur = cur.value
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            return None
    return cur


def _coerce_json(v, dtype: dt.DType):
    if isinstance(v, Json) and dtype.strip_optional() is not dt.JSON:
        v = v.value
    if v is None:
        return None
    base = dtype.strip_optional()
    if base is dt.JSON:
        return v if isinstance(v, Json) else Json(v)
    return dt.coerce(v, dtype)


def _jsonable(v):
    if isinstance(v, Json):
        return v.value
    if isinstance(v, Pointer):
        return repr(v)
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    if isinstance(v, tuple):
        return [_jsonable(x) for x in v]
    try:
        import numpy as np

        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, np.generic):
            return v.item()
    except ImportError:
        pass
    return v


class _JsonLinesWriter:
    def __init__(self, filename: str, column_names: list[str]):
        # the file opens at RUN start (register_output's on_start →
        # start()), not here, so each run rewrites it
        self._file = _utils.WorkerPartFile(filename)
        self._names = column_names
        self._lock = threading.Lock()

    def start(self):
        self._file.reopen()

    def write(self, key, row, time, diff):
        obj = {n: _jsonable(v) for n, v in zip(self._names, row)}
        obj["time"] = time
        obj["diff"] = diff
        with self._lock:
            f = self._file.handle()
            f.write(_json.dumps(obj) + "\n")
            f.flush()

    def close(self):
        self._file.close()


def write(table: Table, filename: str, *, name: str | None = None, **kwargs: Any) -> None:
    r"""Write a table's change stream as JSON Lines (one object per delta).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> import json, tempfile, os
    >>> out = os.path.join(tempfile.mkdtemp(), 'out.jsonl')
    >>> t = pw.debug.table_from_markdown('x\n1\n2')
    >>> pw.io.jsonlines.write(t.select(y=pw.this.x * 10), out)
    >>> _ = pw.run()
    >>> print(sorted(json.loads(l)['y'] for l in open(out)))
    [10, 20]
    """
    writer = _JsonLinesWriter(filename, table.column_names())
    _utils.register_output(
        table, writer.write, on_start=writer.start, on_end=writer.close,
        name=name or f"jsonlines.write:{filename}",
    )

"""Filesystem connector (parity: python/pathway/io/fs).

Formats: binary (whole file), plaintext (line per row),
plaintext_by_file, csv, json — reference io/fs/__init__.py.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io import csv as _csv_mod
from pathway_tpu_torch.io import jsonlines as _jsonlines_mod
from pathway_tpu_torch.io._file_readers import (
    FileReader,
    binary_parse_file,
    only_mode,
    plaintext_by_file_parse,
    plaintext_parse_file,
)


def _data_schema(data_dtype: dt.DType, with_metadata: bool) -> type[schema_mod.Schema]:
    cols = {"data": schema_mod.ColumnSchema(name="data", dtype=data_dtype)}
    if with_metadata:
        cols["_metadata"] = schema_mod.ColumnSchema(name="_metadata", dtype=dt.JSON)
    return schema_mod.schema_from_columns(cols)


def read(
    path: str,
    *,
    format: str = "binary",
    schema: type[schema_mod.Schema] | None = None,
    mode: str = "streaming",
    csv_settings: Any = None,
    json_field_paths: dict | None = None,
    object_pattern: str = "*",
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    debug_data: Any = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    streaming = only_mode(mode)
    if format == "csv":
        return _csv_mod.read(
            path,
            schema=schema,
            csv_settings=csv_settings,
            mode=mode,
            autocommit_duration_ms=autocommit_duration_ms,
            with_metadata=with_metadata,
            object_pattern=object_pattern,
            debug_data=debug_data,
        )
    if format == "json":
        return _jsonlines_mod.read(
            path,
            schema=schema,
            mode=mode,
            json_field_paths=json_field_paths,
            autocommit_duration_ms=autocommit_duration_ms,
            with_metadata=with_metadata,
            object_pattern=object_pattern,
            debug_data=debug_data,
        )
    if format == "plaintext":
        parse, dtype = plaintext_parse_file, dt.STR
    elif format == "plaintext_by_file":
        parse, dtype = plaintext_by_file_parse, dt.STR
    elif format == "binary":
        parse, dtype = binary_parse_file, dt.BYTES
    else:
        raise ValueError(f"unknown fs format {format!r}")
    out_schema = schema or _data_schema(dtype, with_metadata)
    return _utils.make_input_table(
        out_schema,
        lambda: FileReader(
            path, parse, streaming=streaming,
            with_metadata=with_metadata, object_pattern=object_pattern,
        ),
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        debug_data=debug_data,
    )


def write(
    table: Table, filename: str, *, format: str = "json",
    name: str | None = None, **kwargs: Any,
) -> None:
    if format in ("json", "jsonlines"):
        _jsonlines_mod.write(table, filename, name=name)
    elif format == "csv":
        _csv_mod.write(table, filename, name=name)
    else:
        raise ValueError(f"unknown fs write format {format!r}")

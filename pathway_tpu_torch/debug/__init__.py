"""Debug helpers: in-memory tables, capture, printing.

Parity target: ``python/pathway/debug/__init__.py`` (1,045
LoC): ``table_from_markdown`` (with ``_time``/``_diff`` stream columns),
``table_from_rows/pandas/parquet``, ``compute_and_print``,
``compute_and_print_update_stream``, ``table_to_pandas``, ``StreamGenerator``.
"""

from __future__ import annotations

import itertools
from typing import Any, Iterable, Mapping

import numpy as np

from pathway_tpu_torch.engine import dataflow as df
from pathway_tpu_torch.engine.types import Pointer, hash_values, sequential_key
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.runner import run_pipeline_to_completion
from pathway_tpu_torch.internals.table import Lowerer, Table, Universe


def _parse_value(raw: str) -> Any:
    s = raw.strip()
    if s in ("", "None"):
        return None
    if s == "True":
        return True
    if s == "False":
        return False
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        return s[1:-1]
    return s


def _rows_from_markdown(md: str) -> tuple[list[str], list[list[Any]]]:
    """Parse a markdown-ish table.  A leading column with an empty header but
    non-empty row cells is the id column (reference T() convention); columns
    that are empty in the header AND every row are pipe boundaries."""
    lines = [ln.rstrip() for ln in md.strip().splitlines()]
    lines = [ln for ln in lines if ln.strip() and not set(ln.strip()) <= set("|-+: ")]
    header_line = lines[0]
    sep = "|" if "|" in header_line else None
    single_col = sep is None and len(header_line.split()) == 1
    grid = []
    for ln in lines:
        if single_col:
            cells = [ln.strip()]  # one column: whole line is the cell
        else:
            cells = [c.strip() for c in (ln.split(sep) if sep else ln.split())]
        grid.append(cells)
    width = max(len(r) for r in grid)
    for r in grid:
        r.extend([""] * (width - len(r)))
    # drop boundary columns (empty in header AND all rows)
    drop = [
        i
        for i in range(width)
        if all(r[i] == "" for r in grid) and (i == 0 or i == width - 1)
    ]
    grid = [[c for i, c in enumerate(r) if i not in drop] for r in grid]
    headers = grid[0]
    rows = [[_parse_value(c) for c in r] for r in grid[1:]]
    return headers, rows


def _schema_from_data(
    headers: list[str], rows: list[list[Any]]
) -> type[schema_mod.Schema]:
    cols = {}
    for i, h in enumerate(headers):
        seen: dt.DType | None = None
        for r in rows:
            v = r[i] if i < len(r) else None
            d = dt.dtype_of_value(v)
            seen = d if seen is None else dt.types_lca(seen, d)
        cols[h] = schema_mod.ColumnSchema(name=h, dtype=seen or dt.ANY)
    return schema_mod.schema_from_columns(cols)


_static_counter = itertools.count()


def table_from_list_of_tuples(
    keyed_rows: list[tuple[int, tuple, int, int]],
    schema: type[schema_mod.Schema],
) -> Table:
    def build(lowerer: Lowerer) -> df.Node:
        from pathway_tpu_torch.io._utils import register_static_persistence

        node = df.StaticNode(lowerer.scope, keyed_rows)
        register_static_persistence(lowerer, node, schema=schema)
        return node

    return Table(schema, build, universe=Universe())


def table_from_markdown(
    table_def: str,
    id_from: list[str] | None = None,
    unsafe_trusted_ids: bool = False,
    schema: type[schema_mod.Schema] | None = None,
    *,
    _stream: bool = False,
) -> Table:
    r"""Build a static (or, with ``_time`` column, streaming) table from markdown.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('a | b\n1 | x\n2 | y')
    >>> pw.debug.compute_and_print(t, include_id=False)
    a | b
    1 | x
    2 | y
    """
    headers, rows = _rows_from_markdown(table_def)
    has_symbolic_id = bool(headers) and headers[0] in ("", "id")
    special = {"_time", "_diff"}
    data_headers = [
        h for i, h in enumerate(headers) if not (i == 0 and has_symbolic_id) and h not in special
    ]
    time_idx = headers.index("_time") if "_time" in headers else None
    diff_idx = headers.index("_diff") if "_diff" in headers else None

    if schema is None:
        data_positions = [
            i
            for i, h in enumerate(headers)
            if not (i == 0 and has_symbolic_id) and h not in special
        ]
        data_rows = [[r[i] for i in data_positions] for r in rows]
        schema = _schema_from_data(data_headers, data_rows)
        if id_from:
            cols = dict(schema.__columns__)
            schema = schema_mod.schema_from_columns(cols)
    col_dtypes = [schema.__columns__[h].dtype for h in data_headers]
    pk = id_from or schema.primary_key_columns()

    entries = []
    for r in rows:
        values = []
        pos = 0
        sym_id = None
        for i, h in enumerate(headers):
            if i == 0 and has_symbolic_id:
                sym_id = r[i]
                continue
            if h in special:
                continue
            v = r[i] if i < len(r) else None
            values.append(dt.coerce(v, col_dtypes[pos]))
            pos += 1
        t = int(r[time_idx]) if time_idx is not None else 0
        d = int(r[diff_idx]) if diff_idx is not None else 1
        values = tuple(values)
        if sym_id is not None:
            key = hash_values([str(sym_id)])
        elif pk:
            key = hash_values([values[data_headers.index(c)] for c in pk])
        elif unsafe_trusted_ids:
            # reference contract: stable ids from textual row order
            key = sequential_key(len(entries))
        else:
            key = None  # auto key; retractions pair with their addition
        entries.append((key, values, t, d))
    return table_from_list_of_tuples(_assign_auto_keys(entries), schema)


def _assign_auto_keys(entries: list) -> list:
    """Resolve ``None`` keys: fresh sequential keys for additions, and for a
    retraction the key of the most recent *live* addition with identical
    content — matched in time order (not textual order), so streams may be
    written with rows in any order.  An auto-keyed retraction with no live
    matching addition is an authoring error and raises rather than silently
    retracting a row the engine never saw.

    Input/output: ``[(key_or_None, values, time, diff), ...]``.
    """
    seq = itertools.count()
    # additions precede retractions within an epoch, so a same-epoch
    # add/retract pair pairs up regardless of textual order
    order = sorted(
        range(len(entries)), key=lambda i: (entries[i][2], -entries[i][3])
    )
    keys: list = [None] * len(entries)
    live: dict = {}  # values -> [keys of live auto-keyed additions]
    for i in order:
        explicit, values, t, d = entries[i]
        if explicit is not None:
            keys[i] = explicit
        elif d == -1:
            stack = live.get(values)
            if not stack:
                raise ValueError(
                    f"_diff=-1 row {values!r} at _time={t} retracts a row "
                    "that is not live (no earlier matching addition)"
                )
            keys[i] = stack.pop()
        else:
            keys[i] = sequential_key(next(seq))
            live.setdefault(values, []).append(keys[i])
    return [(keys[i], e[1], e[2], e[3]) for i, e in enumerate(entries)]


# T is the conventional alias used across reference tests (tests/utils.py:547)
def T(*args, **kwargs) -> Table:
    return table_from_markdown(*args, **kwargs)


def table_from_rows(
    schema: type[schema_mod.Schema],
    rows: list[tuple],
    unsafe_trusted_ids: bool = False,
    is_stream: bool = False,
) -> Table:
    names = list(schema.__columns__.keys())
    dtypes = [schema.__columns__[n].dtype for n in names]
    pk = schema.primary_key_columns()
    entries = []
    for r in rows:
        if is_stream:
            vals, t, d = list(r[: len(names)]), int(r[len(names)]), int(r[len(names) + 1])
        else:
            vals, t, d = list(r), 0, 1
        vals = [dt.coerce(v, dty) for v, dty in zip(vals, dtypes)]
        if pk:
            key = hash_values([vals[names.index(c)] for c in pk])
        elif unsafe_trusted_ids:
            key = sequential_key(len(entries))  # stable ids from row order
        else:
            key = None
        entries.append((key, tuple(vals), t, d))
    return table_from_list_of_tuples(_assign_auto_keys(entries), schema)


def table_from_pandas(
    df_pd,
    id_from: list[str] | None = None,
    unsafe_trusted_ids: bool = False,
    schema: type[schema_mod.Schema] | None = None,
) -> Table:
    import pandas as pd

    special = {"_time", "_diff"}
    names = [c for c in df_pd.columns if c not in special]
    if schema is None:
        cols = {}
        for c in names:
            series = df_pd[c]
            if series.dtype == np.int64 or series.dtype == np.int32:
                d = dt.INT
            elif series.dtype == np.float64 or series.dtype == np.float32:
                d = dt.FLOAT
            elif series.dtype == np.bool_:
                d = dt.BOOL
            else:
                d = None
                seen = None
                for v in series:
                    vd = dt.dtype_of_value(v)
                    seen = vd if seen is None else dt.types_lca(seen, vd)
                d = seen or dt.ANY
            cols[c] = schema_mod.ColumnSchema(name=c, dtype=d)
        schema = schema_mod.schema_from_columns(cols)
    dtypes = [schema.__columns__[n].dtype for n in names]
    entries = []
    pk = id_from or schema.primary_key_columns()
    for idx, row in df_pd.iterrows():
        vals = []
        for c, dty in zip(names, dtypes):
            v = row[c]
            if isinstance(v, float) and pd.isna(v):
                v = None
            elif v is pd.NaT:
                v = None
            elif isinstance(v, np.integer):
                v = int(v)
            elif isinstance(v, np.floating):
                v = float(v)
            elif isinstance(v, np.bool_):
                v = bool(v)
            elif isinstance(v, pd.Timestamp):
                v = v.to_pydatetime()
            vals.append(dt.coerce(v, dty))
        t = int(row["_time"]) if "_time" in df_pd.columns else 0
        d = int(row["_diff"]) if "_diff" in df_pd.columns else 1
        if pk:
            key = hash_values([vals[names.index(c)] for c in pk])
        elif isinstance(idx, (int, np.integer)) and unsafe_trusted_ids:
            # trusted explicit index: same index retracts the same key
            key = sequential_key(int(idx))
        else:
            key = None
        entries.append((key, tuple(vals), t, d))
    return table_from_list_of_tuples(_assign_auto_keys(entries), schema)


def table_from_parquet(path: str, **kwargs) -> Table:
    import pandas as pd

    return table_from_pandas(pd.read_parquet(path), **kwargs)


def table_to_parquet(table: Table, filename: str) -> None:
    pdf = table_to_pandas(table)
    pdf.to_parquet(filename)


class _Capture:
    def __init__(self):
        self.deltas: list[tuple[int, tuple, int, int]] = []

    def on_data(self, key, row, time, diff):
        self.deltas.append((key, row, time, diff))

    def final_rows(self) -> dict[int, tuple]:
        from collections import Counter

        acc: Counter = Counter()
        for key, row, time, diff in self.deltas:
            acc[(key, row)] += diff
        out = {}
        for (key, row), cnt in acc.items():
            if cnt > 0:
                if cnt != 1:
                    out[key] = row  # duplicated rows collapse; tables are keyed
                else:
                    out[key] = row
        return out


def _capture_table(table: Table, **kwargs) -> _Capture:
    cap = _Capture()

    def attach(lowerer, node):
        return df.OutputNode(lowerer.scope, node, on_data=cap.on_data)

    run_pipeline_to_completion([(table, attach)], **kwargs)
    return cap


def table_to_dicts(table: Table, **kwargs):
    cap = _capture_table(table, **kwargs)
    names = table.column_names()
    rows = cap.final_rows()
    keys = list(rows.keys())
    columns = {
        n: {Pointer(k): rows[k][i] for k in keys} for i, n in enumerate(names)
    }
    return [Pointer(k) for k in keys], columns


def table_to_pandas(table: Table, include_id: bool = True, **kwargs):
    import pandas as pd

    cap = _capture_table(table, **kwargs)
    names = table.column_names()
    rows = cap.final_rows()
    data = {n: [] for n in names}
    idx = []
    for k in sorted(rows.keys()):
        idx.append(Pointer(k))
        for i, n in enumerate(names):
            data[n].append(rows[k][i])
    if include_id:
        return pd.DataFrame(data, index=idx)
    return pd.DataFrame(data)


def _fmt(v) -> str:
    if isinstance(v, str):
        return v
    return repr(v)


def compute_and_print(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    **kwargs,
) -> None:
    r"""Run the graph and print the final state of ``table``.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('v\n2\n1')
    >>> pw.debug.compute_and_print(t, include_id=False)
    v
    1
    2
    """
    cap = _capture_table(table, **kwargs)
    names = table.column_names()
    rows = cap.final_rows()
    header = (["id"] if include_id else []) + [str(n) for n in names]
    lines = []
    for k in sorted(rows.keys()):
        cells = ([repr(Pointer(k))] if include_id else []) + [_fmt(v) for v in rows[k]]
        lines.append(cells)
    lines.sort(key=lambda cells: cells[1:] if include_id else cells)
    if n_rows is not None:
        lines = lines[:n_rows]
    widths = [
        max(len(h), *(len(l[i]) for l in lines)) if lines else len(h)
        for i, h in enumerate(header)
    ]
    print(" | ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip())
    for cells in lines:
        print(" | ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip())


def compute_and_print_update_stream(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    **kwargs,
) -> None:
    r"""Run and print the full change stream with __time__ and __diff__.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('v | _time\n1 | 2\n2 | 4')
    >>> pw.debug.compute_and_print_update_stream(t, include_id=False)
    v | __time__ | __diff__
    1 | 2        | 1
    2 | 4        | 1
    """
    cap = _capture_table(table, **kwargs)
    names = table.column_names()
    header = (["id"] if include_id else []) + [str(n) for n in names] + [
        "__time__",
        "__diff__",
    ]
    entries = sorted(cap.deltas, key=lambda e: (e[2], -e[3], e[0]))
    if n_rows is not None:
        entries = entries[:n_rows]
    lines = []
    for key, row, time, diff in entries:
        cells = ([repr(Pointer(key))] if include_id else []) + [
            _fmt(v) for v in row
        ] + [str(time), str(diff)]
        lines.append(cells)
    widths = [
        max(len(h), *(len(l[i]) for l in lines)) if lines else len(h)
        for i, h in enumerate(header)
    ]
    print(" | ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip())
    for cells in lines:
        print(" | ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip())


def parse_to_table(*args, **kwargs) -> Table:  # legacy alias
    return table_from_markdown(*args, **kwargs)


class StreamGenerator:
    """Deterministic multi-batch stream source (debug/__init__.py:490)."""

    def __init__(self):
        self._counter = itertools.count()

    def table_from_list_of_batches_by_workers(
        self, batches: list[Mapping[int, list[dict]]], schema: type[schema_mod.Schema]
    ) -> Table:
        names = list(schema.__columns__.keys())
        keyed = []
        seq = itertools.count()
        for t, batch_by_worker in enumerate(batches):
            for _worker, entries in batch_by_worker.items():
                for entry in entries:
                    vals = tuple(entry[n] for n in names)
                    keyed.append((sequential_key(next(seq)), vals, 2 * (t + 1), 1))
        return table_from_list_of_tuples(keyed, schema)

    def table_from_list_of_batches(
        self, batches: list[list[dict]], schema: type[schema_mod.Schema]
    ) -> Table:
        return self.table_from_list_of_batches_by_workers(
            [{0: b} for b in batches], schema
        )

    def table_from_markdown(
        self, table: str, **kwargs
    ) -> Table:
        return table_from_markdown(table, **kwargs)

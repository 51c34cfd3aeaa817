"""CSV connector (parity: python/pathway/io/csv)."""

from __future__ import annotations

import csv as _csv
import threading
from typing import Any

from pathway_tpu_torch.engine.types import Pointer
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._file_readers import FileReader, csv_parse_file, only_mode


class CsvParserSettings:
    def __init__(self, delimiter=",", quote='"', escape=None, enable_double_quote_escapes=True, enable_quoting=True, comment_character=None):
        self.delimiter = delimiter
        self.quote = quote
        self.escape = escape
        self.enable_double_quote_escapes = enable_double_quote_escapes
        self.comment_character = comment_character

    def as_dict(self):
        out = {"delimiter": self.delimiter, "quotechar": self.quote}
        if self.escape:
            out["escapechar"] = self.escape
        out["doublequote"] = self.enable_double_quote_escapes
        return out


def read(
    path: str,
    *,
    schema: type[schema_mod.Schema] | None = None,
    csv_settings: CsvParserSettings | None = None,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    with_metadata: bool = False,
    object_pattern: str = "*",
    debug_data: Any = None,
    value_columns: list[str] | None = None,
    primary_key: list[str] | None = None,
    types: dict | None = None,
    **kwargs: Any,
) -> Table:
    r"""Read CSV file(s) into a table (reference io/csv read).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> import os, tempfile
    >>> d = tempfile.mkdtemp()
    >>> with open(os.path.join(d, 'fruit.csv'), 'w') as f:
    ...     _ = f.write('name,qty\napple,3\nplum,7\n')
    >>> t = pw.io.csv.read(d, schema=pw.schema_from_types(name=str, qty=int), mode='static')
    >>> pw.debug.compute_and_print(t.select(pw.this.name, double=pw.this.qty * 2), include_id=False)
    name  | double
    apple | 6
    plum  | 14
    """
    schema = _utils.schema_or_default(schema, value_columns, primary_key, dt.STR)
    # CSV cells arrive as strings; coerce into declared dtypes
    names = list(schema.__columns__.keys())
    dtypes = {n: schema.__columns__[n].dtype for n in names}
    settings = (csv_settings.as_dict() if csv_settings else None)
    base_parse = csv_parse_file(settings)

    simple_settings = csv_settings is None or (
        csv_settings.escape is None and csv_settings.comment_character is None
    )
    vector_ok = (
        not with_metadata
        and simple_settings
        and all(
            dtypes[n].strip_optional() in (dt.INT, dt.FLOAT, dt.BOOL, dt.STR, dt.ANY)
            for n in names
        )
    )
    if vector_ok:
        _warm_pandas()  # main-thread init; the parse runs on the reader thread

    def typed_parse(p, offset):
        if vector_ok:
            parsed = _pandas_parse(p, offset, names, dtypes, csv_settings)
            if parsed is not None:
                raw_batch, total = parsed
                return [raw_batch], total
        rows, new_offset = base_parse(p, offset)

        def gen():
            for row in rows:
                out = {}
                for n in names:
                    raw = row.get(n)
                    out[n] = _convert(raw, dtypes[n])
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


_PANDAS_WARM = False


def _warm_pandas() -> None:
    """Initialize pandas' arrow-string machinery on the MAIN thread.

    pandas 3.0's lazy ArrowStringArray setup is not thread-safe: if its
    first use happens on the connector reader thread the interpreter
    segfaults (reproduced in this environment with pandas 3.0.3 +
    pyarrow 25).  One tiny main-thread parse makes later thread use safe.
    """
    global _PANDAS_WARM
    if _PANDAS_WARM:
        return
    try:
        import io as _io

        import pandas as pd

        pd.read_csv(_io.StringIO("a\nx\n"), dtype=str)
    except Exception:
        pass
    _PANDAS_WARM = True


def _pandas_parse(path, offset, names, dtypes, csv_settings):
    """Vector parse: pandas' C reader + per-column conversion, emitted as
    one ``RawRows`` batch so the poller skips the per-row dict/coerce
    layers.  Returns ``None`` to fall back to the row-at-a-time parser
    whenever exact `_convert` semantics cannot be guaranteed vectorized.
    """
    try:
        import io as _io

        import numpy as np
        import pandas as pd

        delim = csv_settings.delimiter if csv_settings else ","
        quote = csv_settings.quote if csv_settings else '"'
        with open(path, encoding="utf-8", errors="replace", newline="") as f:
            text = f.read()
        # exact-parity guards: quoted cells make field counting ambiguous,
        # and ragged rows diverge from DictReader (None vs "" fills, or
        # pandas' silent implicit-index column shift) — fall back for both
        if quote in text:
            return None
        lines = [ln for ln in text.splitlines() if ln]
        if not lines:
            return None
        counts = np.char.count(np.array(lines, dtype=str), delim)
        if not (counts == counts[0]).all():
            return None
        header = lines[0].split(delim)
        if len(set(header)) != len(header):
            # duplicate header names: DictReader keeps the LAST duplicate,
            # pandas mangles to a.1 — exact parity needs the row path
            return None
        df_pd = pd.read_csv(
            _io.StringIO(text),
            dtype=str,
            keep_default_na=False,
            sep=delim,
            quotechar=quote,
            doublequote=(
                csv_settings.enable_double_quote_escapes if csv_settings else True
            ),
            engine="c",
            index_col=False,
        )
        total = len(df_pd)
        if offset:
            df_pd = df_pd.iloc[offset:]
        cols = []
        n_rows = len(df_pd)
        for n in names:
            base = dtypes[n].strip_optional()
            if n not in df_pd.columns:
                cols.append([None] * n_rows)
                continue
            s = df_pd[n]
            if base is dt.STR or base is dt.ANY:
                cols.append(s.tolist())
            elif base is dt.BOOL:
                cols.append(
                    s.str.strip().str.lower().isin(("true", "1", "yes", "on")).tolist()
                )
            elif base is dt.INT:
                # the C path only for columns of pure ASCII integer
                # LITERALS: '2.0'/'1e3' must stay None like the row path,
                # Unicode digits take the exact per-cell int() semantics,
                # and <= 15 digits keeps float64 round-tripping exact
                lit = s.str.fullmatch(r"[+-]?[0-9]{1,15}")
                if n_rows and lit.all():
                    cols.append(pd.to_numeric(s).to_numpy(np.int64).tolist())
                else:
                    cols.append([_convert(x, dt.INT) for x in s.tolist()])
            elif base is dt.FLOAT:
                # float('nan')/'inf' literals must survive (match _convert)
                cols.append([_convert(x, dt.FLOAT) for x in s.tolist()])
            else:
                return None
        return _utils.RawRows(list(zip(*cols))), total
    except Exception:
        # ANY vector-path surprise falls back to the exact row parser
        return None


def _convert(raw: str | None, dtype: dt.DType):
    if raw is None:
        return None
    base = dtype.strip_optional()
    try:
        if base is dt.INT:
            return int(raw)
        if base is dt.FLOAT:
            return float(raw)
        if base is dt.BOOL:
            return raw.strip().lower() in ("true", "1", "yes", "on")
        if base is dt.STR or base is dt.ANY:
            return raw
    except (ValueError, TypeError):
        return None
    return raw


class _CsvWriter:
    def __init__(self, filename: str, column_names: list[str]):
        # the file opens at RUN start, not build (see _JsonLinesWriter)
        self._w: _csv.writer | None = None

        def on_open(f):
            self._w = _csv.writer(f)
            self._w.writerow(column_names + ["time", "diff"])

        self._file = _utils.WorkerPartFile(filename, newline="", on_open=on_open)
        self._lock = threading.Lock()

    def start(self):
        self._file.reopen()

    def write(self, key, row, time, diff):
        with self._lock:
            f = self._file.handle()
            self._w.writerow([_fmt_cell(v) for v in row] + [time, diff])
            f.flush()

    def close(self):
        self._file.close()


def _fmt_cell(v):
    if isinstance(v, Pointer):
        return repr(v)
    return v


def write(table: Table, filename: str, *, name: str | None = None, **kwargs: Any) -> None:
    """Write the table's change stream as CSV (columns + time + diff)."""
    writer = _CsvWriter(filename, table.column_names())
    _utils.register_output(
        table,
        writer.write,
        on_start=writer.start,
        on_end=writer.close,
        name=name or f"csv.write:{filename}",
    )

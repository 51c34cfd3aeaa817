"""``pw.demo`` — synthetic streams (parity: python/pathway/demo/__init__.py:28-310)."""

from __future__ import annotations

import csv as _csv
import time as _time
from typing import Any, Callable, Mapping

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._utils import COMMIT, Reader
from pathway_tpu_torch.io.python import ConnectorSubject


class _GeneratorReader(Reader):
    def __init__(self, nb_rows, row_fn, input_rate):
        self.nb_rows = nb_rows
        self.row_fn = row_fn
        self.input_rate = input_rate

    def run(self, emit) -> None:
        i = 0
        while self.nb_rows is None or i < self.nb_rows:
            emit(self.row_fn(i))
            emit(COMMIT)
            i += 1
            if self.input_rate:
                _time.sleep(1.0 / self.input_rate)


def generate_custom_stream(
    value_generators: Mapping[str, Callable[[int], Any]],
    *,
    schema: type[schema_mod.Schema],
    nb_rows: int | None = None,
    autocommit_duration_ms: int = 1000,
    input_rate: float = 1.0,
    persistent_id: str | None = None,
) -> Table:
    """Generate a stream from per-column generator functions.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> class S(pw.Schema):
    ...     n: int
    >>> t = pw.demo.generate_custom_stream(
    ...     value_generators={'n': lambda i: i * i},
    ...     schema=S,
    ...     nb_rows=3,
    ...     autocommit_duration_ms=10,
    ...     input_rate=1000.0,
    ... )
    >>> pw.debug.compute_and_print(t, include_id=False)
    n
    0
    1
    4
    """

    def row_fn(i: int) -> dict:
        return {name: gen(i) for name, gen in value_generators.items()}

    return _utils.make_input_table(
        schema,
        lambda: _GeneratorReader(nb_rows, row_fn, input_rate),
        autocommit_duration_ms=autocommit_duration_ms,
    )


def noisy_linear_stream(nb_rows: int = 10, input_rate: float = 1.0) -> Table:
    """y ≈ x with noise (docs tutorial stream)."""
    import random

    schema = schema_mod.schema_from_types(x=float, y=float)
    rng = random.Random(0)

    def row_fn(i: int) -> dict:
        return {"x": float(i), "y": float(i) + (2.0 * rng.random() - 1.0)}

    return _utils.make_input_table(
        schema, lambda: _GeneratorReader(nb_rows, row_fn, input_rate)
    )


def range_stream(
    nb_rows: int = 30, offset: int = 0, input_rate: float = 1.0, autocommit_duration_ms: int = 1000
) -> Table:
    schema = schema_mod.schema_from_types(value=float)

    def row_fn(i: int) -> dict:
        return {"value": float(i + offset)}

    return _utils.make_input_table(
        schema,
        lambda: _GeneratorReader(nb_rows, row_fn, input_rate),
        autocommit_duration_ms=autocommit_duration_ms,
    )


def replay_csv(
    path: str,
    *,
    schema: type[schema_mod.Schema],
    input_rate: float = 1.0,
) -> Table:
    """Replay a CSV file as a stream at input_rate rows/sec."""
    names = list(schema.__columns__.keys())
    dtypes = {n: schema.__columns__[n].dtype for n in names}

    class _ReplayReader(Reader):
        def run(self, emit) -> None:
            from pathway_tpu_torch.io.csv import _convert

            with open(path, newline="") as f:
                for row in _csv.DictReader(f):
                    emit({n: _convert(row.get(n), dtypes[n]) for n in names})
                    emit(COMMIT)
                    if input_rate:
                        _time.sleep(1.0 / input_rate)

    return _utils.make_input_table(schema, _ReplayReader)


def replay_csv_with_time(
    path: str,
    *,
    schema: type[schema_mod.Schema],
    time_column: str,
    unit: str = "s",
    autocommit_ms: int = 100,
    speedup: float = 1,
) -> Table:
    """Replay a CSV using its own time column to pace the stream."""
    names = list(schema.__columns__.keys())
    dtypes = {n: schema.__columns__[n].dtype for n in names}
    div = {"s": 1.0, "ms": 1e3, "us": 1e6, "ns": 1e9}[unit] * speedup

    class _ReplayReader(Reader):
        def run(self, emit) -> None:
            from pathway_tpu_torch.io.csv import _convert

            prev_t = None
            with open(path, newline="") as f:
                for row in _csv.DictReader(f):
                    parsed = {n: _convert(row.get(n), dtypes[n]) for n in names}
                    t = parsed.get(time_column)
                    if prev_t is not None and t is not None:
                        delay = (t - prev_t) / div
                        if delay > 0:
                            _time.sleep(min(delay, 10.0))
                    prev_t = t if t is not None else prev_t
                    emit(parsed)
                    emit(COMMIT)

    return _utils.make_input_table(schema, _ReplayReader)

"""Persisted programs shared by the port's persistence tests.

Each program is a function of a package — ``pathway_tpu`` or
``pathway_tpu_torch``, passed as ``pw`` — that builds a small Table
program over files or a Python subject, runs it with a persistence config
on a root the caller gives, and returns the changes its subscriber saw as
canonical ``(key, row, time, is_addition)`` tuples
(``tests/torch_dataflow_programs.py``'s :func:`canon`).  A test runs the
same program with stop and resume in both packages and holds the streams
to each other: a connector's rows land in the epochs its reader thread's
pace gives them, so streams are compared without their times
(:func:`untimed`).

:func:`kill_worker` is the SIGKILL matrix's worker
(``tests/test_persistence_matrix.py``'s ``_worker``): started in a forked
child for either package, on the pure-Python core.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from pathlib import Path

from tests.torch_dataflow_programs import canon, sub


def config(pw, root, mode: str | None = None, **kwargs):
    """A ``pw.persistence.Config`` on a filesystem root, or on ``root``'s
    dict when it is one (the mock backend), in ``PersistenceMode.<mode>``."""
    if isinstance(root, dict):
        backend = pw.persistence.Backend.mock()
        backend.store = root
    else:
        backend = pw.persistence.Backend.filesystem(str(root))
    persistence_mode = getattr(pw.PersistenceMode, mode) if mode else None
    return pw.persistence.Config(backend, persistence_mode=persistence_mode, **kwargs)


def subscribe(pw, table) -> list:
    """The changes ``table``'s subscriber will see, canonical."""
    seen: list = []
    pw.io.subscribe(
        table,
        on_change=lambda key, row, time, is_addition: seen.append(
            (int(key.value), tuple((n, canon(v)) for n, v in row.items()), time, is_addition)),
    )
    return seen


def run(pw, table, root, mode: str | None = None) -> list:
    """``table`` run once with persistence on ``root``; its changes."""
    seen = subscribe(pw, table)
    try:
        pw.run(persistence_config=config(pw, root, mode), monitoring_level=pw.MonitoringLevel.NONE)
    finally:
        pw.G.clear()
    return seen


def untimed(changes) -> list:
    return sorted((k, r, add) for k, r, _t, add in changes)


def final(changes) -> dict:
    """``{key: row}`` after a change stream, in the order it came."""
    live: dict = {}
    for key, row, _t, add in changes:
        if add:
            live[key] = row
        elif live.get(key) == row:
            del live[key]
    return live


def values(changes, *columns) -> list:
    """``(column value, ..., is_addition)`` of each change, in order."""
    out = []
    for _k, row, _t, add in changes:
        cols = dict(row)
        out.append(tuple(cols[c][1] for c in columns) + (add,))
    return out


def words(pw, input_dir, root, mode: str | None = None) -> list:
    """The word count of a directory of CSV files (``test_persistence.py``)."""
    t = pw.io.csv.read(str(input_dir), schema=pw.schema_from_types(word=str), mode="static", name="words")
    return run(pw, t.groupby(t.word).reduce(t.word, n=pw.reducers.count()), root, mode)


def subject(pw, rows, *, commit_each: bool = False):
    """A ``ConnectorSubject`` that emits ``rows`` (dicts) and commits."""

    class Src(pw.io.python.ConnectorSubject):
        def run(self):
            for row in rows:
                if "_pw_key" in row:
                    self._emit(dict(row))
                else:
                    self.next(**row)
                if commit_each:
                    self.commit()
            self.commit()

    return Src()


def subject_sum(pw, root, n: int = 5) -> list:
    t = pw.io.python.read(subject(pw, [{"k": i, "v": i * 10} for i in range(n)]),
                          schema=pw.schema_from_types(k=int, v=int), name="pysrc")
    return run(pw, t.reduce(total=pw.reducers.sum(t.v)), root)


def subject_count(pw, root, lo: int, hi: int, mode: str | None = None) -> list:
    t = pw.io.python.read(subject(pw, [{"k": i} for i in range(lo, hi)]),
                          schema=pw.schema_from_types(k=int), name="s")
    return run(pw, t.reduce(n=pw.reducers.count()), root, mode)


def subject_rows(pw, root, rows, mode: str | None = None, schema=None, name: str = "s") -> list:
    t = pw.io.python.read(subject(pw, rows), schema=schema or pw.schema_from_types(k=int), name=name)
    return run(pw, t, root, mode)


def join_agg(pw, input_dir, root) -> list:
    """A self-join through a groupby (``test_operator_persistence.py``)."""
    left = pw.io.csv.read(str(input_dir), schema=pw.schema_from_types(k=int, v=str), mode="static", name="left")
    agg = left.groupby(left.k).reduce(left.k, vs=pw.reducers.sorted_tuple(left.v))
    joined = left.join(agg, pw.left.k == pw.right.k).select(v=pw.left.v, vs=pw.right.vs)
    return run(pw, joined, root, "OPERATOR_PERSISTING")


def increasing(pw, input_dir, root) -> list:
    """``deduplicate`` accepting only strictly increasing values."""
    t = pw.io.csv.read(str(input_dir), schema=pw.schema_from_types(v=int), mode="static", name="src")
    return run(pw, t.deduplicate(value=pw.this.v, acceptor=lambda new, old: new > old), root,
               "OPERATOR_PERSISTING")


def total(pw, input_dir, root, extra_op: bool = False) -> list:
    t = pw.io.csv.read(str(input_dir), schema=pw.schema_from_types(v=int), mode="static", name="src")
    if extra_op:
        t = t.filter(pw.this.v > 0)
    return run(pw, t.reduce(total=pw.reducers.sum(pw.this.v)), root, "OPERATOR_PERSISTING")


def cached_embeddings(pw, texts, root, calls: list) -> list:
    """An async UDF under ``pw.udfs.DiskCache()`` over ``texts``, the run
    persisted in ``UDF_CACHING`` mode on ``root``; ``calls`` gains the text
    of every call the cache let through."""

    @pw.udf(executor=pw.udfs.async_executor(), cache_strategy=pw.udfs.DiskCache(), deterministic=True)
    async def embed(text: str) -> list:
        calls.append(text)
        await asyncio.sleep(0)
        return [float(len(text)), float(sum(map(ord, text)) % 97)]

    t = pw.io.python.read(subject(pw, [{"text": x} for x in texts]), schema=pw.schema_from_types(text=str),
                          name="texts")
    return run(pw, t.select(pw.this.text, vec=embed(pw.this.text)), root, "UDF_CACHING")


# ---------------------------------------------------------------------------
# The SIGKILL matrix's worker
# ---------------------------------------------------------------------------

KILL_ROWS = 24
KILL_ROW_DELAY_S = 0.04


def kill_pipeline(pw, shape: str, t):
    if shape == "groupby":
        return t.groupby(t.k).reduce(k=t.k, n=pw.reducers.count())
    if shape == "join":
        sides = pw.debug.table_from_markdown(
            """
            k | name
            0 | zero
            1 | one
            2 | two
            """
        )
        joined = t.join(sides, t.k == sides.k).select(name=sides.name, v=t.v)
        return joined.groupby(pw.this.name).reduce(k=pw.this.name, n=pw.reducers.sum(pw.this.v))
    assert shape == "deduplicate", shape
    dedup = t.deduplicate(value=t.k, acceptor=lambda new, old: True)
    return dedup.groupby(dedup.k).reduce(k=dedup.k, n=pw.reducers.count())


def kill_worker(package: str, pstore: str, out_path: str, shape: str, mode: str, n_rows: int,
                row_delay: float) -> None:
    """One run of the matrix's program, in a forked child, on the package's
    pure-Python core."""
    import importlib

    os.environ["PATHWAY_NATIVE"] = "0"
    pw = importlib.import_module(package)
    native = sub(pw, "native")
    native._loaded, native._module = True, None
    pw.G.clear()

    class Src(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(n_rows):
                self.next(k=i % 3, v=1)
                self.commit()
                if row_delay:
                    time.sleep(row_delay)

    t = pw.io.python.read(Src(), schema=pw.schema_from_types(k=int, v=int), name="src")
    pw.io.jsonlines.write(kill_pipeline(pw, shape, t), out_path)
    pw.run(
        persistence_config=pw.persistence.Config(
            pw.persistence.Backend.filesystem(pstore),
            snapshot_interval_ms=50,
            persistence_mode=pw.PersistenceMode.OPERATOR_PERSISTING if mode == "operator" else None,
        ),
        monitoring_level=pw.MonitoringLevel.NONE,
    )


def net_state(path: str) -> dict:
    """The net ``{k: n}`` of a jsonlines output, tolerating a torn tail."""
    state: dict = {}
    for line in Path(path).read_text().splitlines():
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn tail write from a kill
        diff = obj.pop("diff")
        key = obj["k"]
        if diff > 0:
            state[key] = obj["n"]
        elif state.get(key) == obj["n"]:
            del state[key]
    return state

"""Table programs shared by the dataflow parity tests.

Each program is a function of a package — ``pathway_tpu`` or
``pathway_tpu_torch``, passed as ``pw`` — that builds tables from inputs
drawn with numpy from a fixed seed and returns ``{name: table}``.
:func:`capture` runs every returned table through the package's own
``pw.debug._capture_table`` and gives its change stream as canonical,
sortable ``(time, key, diff, row)`` tuples, so that two packages (or two
paths of one package) can be held to each other with ``==``, keys, times
and float bits included.

The embedding program is ``chip_smoke.py``'s ``[dataflow]`` program at a
small size (:func:`capture_embedding`): an async UDF embeds each doc
through the package's ``AsyncMicroBatcher`` over a sentence encoder, so
its rows are held with tolerances where they carry vectors; so is
``[temporal]``'s windowed topic monitor (:func:`capture_temporal_embedding`).
The temporal slice's programs (windows, behaviors, time joins) and
``pw.graphs``' are :func:`temporal_program` and :func:`graph_program`.

Run as a script (``python -m tests.torch_dataflow_programs OUT [SUITE |
MODEL_DIR PARAMS]``), it captures every program of the port into the
pickle ``OUT`` under the environment it was started in, with the columnar
path on and off; given a suite (``temporal``, ``graphs``), that suite's
programs; given the encoder's config directory and its weights (a pickle
of numpy arrays), the embedding program alone.  The parity tests start it
with ``PATHWAY_NATIVE=0`` for the pure-Python core.
"""

from __future__ import annotations

import asyncio
import datetime
import functools
import importlib
import os
import pickle
import subprocess
import sys

import numpy as np

SEED = 11
WORDS = ("alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta")


def canon(v):
    """A value in a form that compares equal across the two packages
    exactly when the values are the same: floats by their bits, arrays
    by dtype, shape and bytes, the two packages' ``Pointer``/``Json``/
    ``ERROR`` classes by name."""
    if isinstance(v, bool) or v is None or isinstance(v, (int, str, bytes)):
        return (type(v).__name__, v)
    if isinstance(v, float):
        return ("float", v.hex())
    if isinstance(v, np.ndarray):
        return ("ndarray", str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, tuple):
        return ("tuple", tuple(canon(x) for x in v))
    name = type(v).__name__
    if name == "Pointer":
        return ("Pointer", v.value)
    if name == "Json":
        return ("Json", repr(v.value))
    if name == "Error":
        return ("Error",)
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return canon(v.item())
    return (name, repr(v))


def capture(pw, tables: dict, **kwargs) -> dict:
    """``{name: sorted [(time, key, diff, row)]}`` of each table's change
    stream (``_capture_table`` runs each table's cone on its own)."""
    out = {}
    for name, table in tables.items():
        deltas = pw.debug._capture_table(table, **kwargs).deltas
        out[name] = sorted((t, int(k), d, canon(r)) for k, r, t, d in deltas)
    return out


def live_snapshot(pw) -> tuple:
    """``Table.live()`` of a one-row table, run to its end: whether the
    final snapshot is done, its ``(key, row)`` pairs, and the warnings the
    call gave."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        live = pw.debug.table_from_markdown("v\n1").live()
    snap = live.wait_for(30).snapshot()
    return snap.done, [(int(k), canon(r)) for k, r in snap.data], [str(w.message) for w in caught]


def _stamp(n: int, times: tuple, rng) -> list[int]:
    return [int(t) for t in rng.choice(times, size=n)]


# ---------------------------------------------------------------------------
# per-row work: select (arithmetic, string, date-time, if_else, coalesce),
# filter, flatten
# ---------------------------------------------------------------------------


def per_row(pw) -> dict:
    rng = np.random.default_rng(SEED)
    n = 160
    base = datetime.datetime(2024, 3, 9, 22, 15)
    schema = pw.schema_from_types(i=int, x=float, s=str, ts=pw.DateTimeNaive, opt=int | None)
    rows = []
    for i, (x, t, h) in enumerate(zip(rng.normal(size=n), _stamp(n, (2, 4, 6), rng), rng.integers(0, 500, n))):
        words = " ".join(rng.choice(WORDS, size=int(rng.integers(1, 4))))
        opt = None if i % 4 == 0 else int(rng.integers(-9, 9))
        rows.append((i, float(x), words, base + datetime.timedelta(minutes=int(h) * 7), opt, t, 1))
    t = pw.debug.table_from_rows(schema, rows, is_stream=True)
    sel = t.select(
        a=pw.this.i * 3 + 1,
        b=pw.this.x / 2.5,
        c=pw.this.i // 7,
        d=pw.this.i % 5,
        e=pw.this.x ** 2,
        f=-pw.this.x + pw.this.i,
        g=pw.this.x.num.abs(),
        h=pw.this.x.num.round(2),
        up=pw.this.s.str.upper(),
        ln=pw.this.s.str.len(),
        cat=pw.this.s + "!",
        sl=pw.this.s.str.slice(1, 4),
        rep=pw.this.s.str.replace("a", "o"),
        yr=pw.this.ts.dt.year(),
        hr=pw.this.ts.dt.hour(),
        fmt=pw.this.ts.dt.strftime("%Y-%m-%d %H:%M"),
        later=pw.this.ts + datetime.timedelta(hours=5),
        fl=pw.this.ts.dt.floor(datetime.timedelta(hours=1)),
        ie=pw.if_else(pw.this.x > 0, pw.this.i, -pw.this.i),
        co=pw.coalesce(pw.this.opt, -1),
        both=(pw.this.i > 50) & (pw.this.x < 0.5),
    )
    filt = sel.filter((pw.this.d != 0) & (pw.this.b < 0.3))
    split = t.select(
        i=pw.this.i, w=pw.apply_with_type(lambda s: tuple(s.split(" ")), tuple, pw.this.s)
    )
    return {"select": sel, "filter": filt, "flatten": split.flatten(pw.this.w)}


# ---------------------------------------------------------------------------
# grouping: groupby().reduce with every reducer of the slice
# ---------------------------------------------------------------------------


def grouping(pw) -> dict:
    rng = np.random.default_rng(SEED + 1)
    n = 200
    schema = pw.schema_from_types(g=str, v=int, f=float)
    rows = [
        (str(rng.choice(WORDS[:5])), int(v), float(f), t, 1)
        for v, f, t in zip(rng.integers(-50, 50, n), rng.normal(size=n), _stamp(n, (2, 4), rng))
    ]
    t = pw.debug.table_from_rows(schema, rows, is_stream=True)

    @pw.reducers.stateful_single
    def running_max(state, value):
        return value if state is None or value > state else state

    red = t.groupby(pw.this.g).reduce(
        g=pw.this.g,
        cnt=pw.reducers.count(),
        s=pw.reducers.sum(pw.this.v),
        sf=pw.reducers.sum(pw.this.f),
        mn=pw.reducers.min(pw.this.v),
        mx=pw.reducers.max(pw.this.f),
        am=pw.reducers.argmin(pw.this.v),
        tup=pw.reducers.tuple(pw.this.v),
        st=pw.reducers.sorted_tuple(pw.this.v),
        nd=pw.reducers.ndarray(pw.this.f),
        av=pw.reducers.avg(pw.this.f),
        rm=running_max(pw.this.v),
    )
    two = t.with_columns(m=pw.this.v % 3).groupby(pw.this.g, pw.this.m).reduce(
        g=pw.this.g, m=pw.this.m, c=pw.reducers.count(), s=pw.reducers.sum(pw.this.f)
    )
    # Nones in a summed column: the columnar groupby bails to the row path
    sparse = t.select(g=pw.this.g, o=pw.if_else(pw.this.v > 0, pw.this.v, None)).groupby(pw.this.g).reduce(
        g=pw.this.g, s=pw.reducers.sum(pw.this.o), c=pw.reducers.count()
    )
    return {"reduce": red, "two_keys": two, "sparse_sum": sparse}


# ---------------------------------------------------------------------------
# joins: the four modes, ix, concat, update_rows/update_cells, with_id_from,
# deduplicate, sort and an iterate fixpoint
# ---------------------------------------------------------------------------


def joins(pw) -> dict:
    rng = np.random.default_rng(SEED + 2)
    left_s = pw.schema_from_types(k=int, a=str)
    right_s = pw.schema_from_types(k=int, b=float)
    lk = rng.choice(np.arange(120), size=90, replace=False)
    rk = rng.choice(np.arange(120), size=90, replace=False)
    A = pw.debug.table_from_rows(left_s, [(int(k), str(rng.choice(WORDS)), t, 1)
                                          for k, t in zip(lk, _stamp(90, (2, 4), rng))], is_stream=True)
    B = pw.debug.table_from_rows(right_s, [(int(k), float(x), t, 1)
                                           for k, x, t in zip(rk, rng.normal(size=90), _stamp(90, (2, 4), rng))],
                                 is_stream=True)
    inner = A.join(B, pw.left.k == pw.right.k).select(k=pw.left.k, a=pw.left.a, b=pw.right.b)
    left = A.join_left(B, pw.left.k == pw.right.k).select(k=pw.left.k, a=pw.left.a, b=pw.right.b)
    right = A.join_right(B, pw.left.k == pw.right.k).select(k=pw.right.k, a=pw.left.a, b=pw.right.b)
    outer = A.join_outer(B, pw.left.k == pw.right.k).select(
        k=pw.coalesce(pw.left.k, pw.right.k), a=pw.left.a, b=pw.right.b
    )
    Bk = B.with_id_from(pw.this.k)
    looked = A.select(a=pw.this.a, b=Bk.ix(Bk.pointer_from(pw.this.k), optional=True).b)
    lo = A.filter(pw.this.k < 60)
    hi = A.filter(pw.this.k >= 60)
    both = lo.concat(hi)
    patch = A.filter(pw.this.k % 4 == 0).select(k=pw.this.k, a=pw.this.a + "~")
    rows = A.update_rows(patch)
    cells = A.update_cells(patch.select(a=pw.this.a))
    dedup = B.deduplicate(value=pw.this.b, acceptor=lambda new, old: new > old)
    s = A.sort(key=pw.this.k)
    prev = A.with_columns(prev_k=A.ix(s.prev, optional=True).k)

    def collatz(tab):
        nxt = pw.apply_with_type(lambda n: n if n == 1 else (n // 2 if n % 2 == 0 else 3 * n + 1), int, pw.this.n)
        return dict(tab=tab.select(n=nxt))

    seeds = pw.debug.table_from_rows(pw.schema_from_types(n=int), [(int(n),) for n in rng.integers(1, 40, 12)])
    fix = pw.iterate(lambda tab: collatz(tab), tab=seeds)
    return {
        "inner": inner, "left": left, "right": right, "outer": outer, "ix": looked, "concat": both,
        "update_rows": rows, "update_cells": cells, "deduplicate": dedup, "sort": prev, "iterate": fix,
    }


# ---------------------------------------------------------------------------
# streams: _time/_diff with retractions and updates of the same key
# ---------------------------------------------------------------------------


def streams(pw) -> dict:
    rng = np.random.default_rng(SEED + 3)

    class Keyed(pw.Schema):
        k: int = pw.column_definition(primary_key=True)
        g: str
        v: int

    rows, live = [], {}
    for time in (2, 4, 6, 8, 10):
        for k in rng.choice(np.arange(80), size=40, replace=False):
            k = int(k)
            if k in live:  # retract the live row; replace it or leave it gone
                rows.append((k, *live.pop(k), time, -1))
                if rng.random() < 0.5:
                    continue
            live[k] = (str(rng.choice(WORDS[:4])), int(rng.integers(0, 100)))
            rows.append((k, *live[k], time, 1))
    t = pw.debug.table_from_rows(Keyed, rows, is_stream=True)
    sel = t.select(k=pw.this.k, g=pw.this.g, w=pw.this.v * 2 + 1)
    red = t.groupby(pw.this.g).reduce(
        g=pw.this.g, c=pw.reducers.count(), s=pw.reducers.sum(pw.this.v),
        mn=pw.reducers.min(pw.this.v), mx=pw.reducers.max(pw.this.v),
    )
    names = pw.debug.table_from_rows(pw.schema_from_types(g=str, label=str),
                                     [(w, w.upper()) for w in WORDS[:4]])
    joined = red.join(names, pw.left.g == pw.right.g).select(label=pw.right.label, s=pw.left.s)
    return {"select": sel, "reduce": red, "join": joined}


# ---------------------------------------------------------------------------
# UDFs: sync with max_batch_size, async through async_executor(capacity=…)
# with a retraction of a computed row, and a raising UDF (ERROR)
# ---------------------------------------------------------------------------


def udfs(pw) -> dict:
    rng = np.random.default_rng(SEED + 4)

    class Keyed(pw.Schema):
        k: int = pw.column_definition(primary_key=True)
        x: int

    rows = [(k, int(x), 2, 1) for k, x in enumerate(rng.integers(0, 50, 100))]
    rows += [(k, x, 4, -1) for k, x, _, _ in rows[:30:3]]  # retract rows the async UDF computed
    rows += [(k, x + 1, 4, 1) for k, x, _, _ in rows[:30:6]]
    t = pw.debug.table_from_rows(Keyed, rows, is_stream=True)

    @pw.udf(max_batch_size=8)
    def poly(x: int) -> int:
        return x * x - 3 * x

    @pw.udf(executor=pw.udfs.async_executor(capacity=4))
    async def slow_double(x: int) -> float:
        await asyncio.sleep(0)
        return x * 2.5

    @pw.udf
    def fragile(x: int) -> int:
        if x % 7 == 3:
            raise ValueError("x is 3 mod 7")
        return x + 1

    return {
        "sync": t.select(k=pw.this.k, p=poly(pw.this.x)),
        "async": t.select(k=pw.this.k, d=slow_double(pw.this.x)),
        "error": t.select(k=pw.this.k, f=fragile(pw.this.x)),
    }


PROGRAMS = {"per_row": per_row, "grouping": grouping, "joins": joins, "streams": streams, "udfs": udfs}


def capture_program(pw, name: str) -> dict:
    if name != "udfs":
        return capture(pw, PROGRAMS[name](pw))
    # the raising UDF must yield ERROR, not stop the run: the evaluator reads
    # the config's switch, the scope the run's
    with pw.local_pathway_config(terminate_on_error=False):
        return capture(pw, PROGRAMS[name](pw), terminate_on_error=False)


# ---------------------------------------------------------------------------
# the [dataflow] phase's program at a small size
# ---------------------------------------------------------------------------

EMBED_DOCS, EMBED_EPOCHS, EMBED_CHANGES, EMBED_SOURCES = 96, 4, 8, 6
EMBED_BATCH = 8


def embed_stream() -> dict:
    import chip_smoke

    texts, _, _, _ = chip_smoke.synthetic_corpus(EMBED_DOCS + EMBED_CHANGES, SEED + 5, words_per_text=(3, 14))
    return chip_smoke.dataflow_stream(texts, EMBED_DOCS, EMBED_EPOCHS, EMBED_CHANGES, EMBED_SOURCES, SEED + 6)


def embed_query(dim: int) -> np.ndarray:
    q = np.random.default_rng(SEED + 7).normal(size=dim).astype(np.float32)
    return q / np.linalg.norm(q)


def plain(v):
    """A row value without the package's own classes: arrays as numpy."""
    return np.array(v) if isinstance(v, np.ndarray) else v


def capture_embedding(pw, encode, dim: int, executor=None) -> dict:
    """``{name: sorted [(time, key, diff, row)]}`` of the embedding
    program's tables, rows of plain values, with ``encode`` (a
    ``SentenceEncoder.encode``) behind the package's micro-batcher."""
    import chip_smoke

    batching = importlib.import_module(pw.__name__ + ".utils.batching")
    batcher = batching.AsyncMicroBatcher(encode, max_batch_size=EMBED_BATCH, executor=executor)
    tables = chip_smoke.dataflow_program(pw, embed_stream(), chip_smoke.embedding_udf(pw, batcher.submit),
                                         embed_query(dim))
    out = {}
    for name, table in tables.items():
        deltas = pw.debug._capture_table(table).deltas
        out[name] = sorted(((t, int(k), d, tuple(plain(v) for v in r)) for k, r, t, d in deltas),
                           key=lambda e: e[:3])
    return out


TEMPORAL_BATCH = 64  # one forward an epoch: fewer shapes for the JAX encoder to compile
# [temporal]'s input at a small size: 128 events over 6 hours in 8 commits, 16 alerts, 8 questions
TEMPORAL_SIZES = dict(n_events=128, commits=8, n_alerts=16, n_questions=8, span=6 * 3600)


def capture_temporal_embedding(pw, encode, executor=None) -> dict:
    """``{name: [(time, key, diff, row)]}`` of the ``[temporal]`` program's
    tables at a small size, in the order one ``pw.run`` delivered them,
    rows as ``{column: plain value}``: its commits staged as epochs 2, 4,
    ... by ``pw.debug.table_from_rows``, ``encode`` (a
    ``SentenceEncoder.encode``) behind the package's micro-batcher."""
    import chip_smoke

    batching = importlib.import_module(pw.__name__ + ".utils.batching")
    batcher = batching.AsyncMicroBatcher(encode, max_batch_size=TEMPORAL_BATCH, executor=executor)
    schema = chip_smoke.temporal_schema(pw)
    names = list(schema.__columns__)
    batches = chip_smoke.temporal_stream(**TEMPORAL_SIZES, seed=SEED + 8)
    rows = [tuple(row[n] for n in names) + (2 + 2 * b, 1) for b, batch in enumerate(batches) for row in batch]
    stream = pw.debug.table_from_rows(schema, rows, is_stream=True)
    tables = chip_smoke.temporal_program(pw, stream, chip_smoke.embedding_udf(pw, batcher.submit))
    out = {name: [] for name in tables}
    for name, table in tables.items():
        table._subscribe_raw(lambda k, r, t, d, rows=out[name], cols=table.column_names():
                             rows.append((t, int(k), d, dict(zip(cols, (plain(v) for v in r))))))
    try:
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    finally:
        pw.G.clear()
    return out


def port_encoder(model_dir: str, params):
    """The port's sentence encoder of ``model_dir`` on the CPU, carrying
    ``params`` (the JAX encoder's tree, as numpy)."""
    import pathway_tpu_torch as pt

    saved = sys.modules.get("transformers", "absent")
    sys.modules["transformers"] = None  # the config's own tokenizer, no download
    try:
        enc = pt.SentenceEncoder(model_dir, seed=0, device="cpu")
    finally:
        if saved == "absent":
            del sys.modules["transformers"]
        else:
            sys.modules["transformers"] = saved
    enc.set_params(params)
    return enc


# ---------------------------------------------------------------------------
# connectors, indexes and the LLM xpack: programs of either package
# ---------------------------------------------------------------------------


def port_kw(pw) -> dict:
    """The port's own ``device`` keyword: its indexes and embedders run on
    the card unless the caller names the CPU."""
    return {"device": "cpu"} if pw.__name__.endswith("_torch") else {}


def sub(pw, name: str):
    """The package's submodule ``name`` (``"io._utils"``, ...)."""
    return importlib.import_module(f"{pw.__name__}.{name}")


class PinnedClock:
    """Stands in for ``_file_readers``' ``time`` module: a fixed wall clock,
    so the ``seen_at`` of file metadata is the same in both packages."""

    @staticmethod
    def time() -> float:
        return 1.7e9

    sleep = staticmethod(__import__("time").sleep)


def write_corpus(root, seed: int, n: int = 3) -> None:
    """A directory per fs format under ``root``: ``txt`` (lines of words),
    ``csv`` (name, qty) and ``json`` (name, qty, tags lines)."""
    import json
    import os

    rng = np.random.default_rng(seed)
    for d in ("txt", "csv", "json"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n):
        lines = [" ".join(rng.choice(WORDS, size=int(rng.integers(2, 7)))) for _ in range(int(rng.integers(1, 4)))]
        with open(os.path.join(root, "txt", f"doc{i}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        rows = [(str(rng.choice(WORDS)), int(rng.integers(0, 99))) for _ in range(int(rng.integers(1, 4)))]
        with open(os.path.join(root, "csv", f"part{i}.csv"), "w") as f:
            f.write("name,qty\n" + "".join(f"{a},{b}\n" for a, b in rows))
        with open(os.path.join(root, "json", f"part{i}.jsonl"), "w") as f:
            for a, b in rows:
                f.write(json.dumps({"name": a, "qty": b, "tags": [a, b]}) + "\n")


FS_FORMATS = {"binary": "txt", "plaintext": "txt", "plaintext_by_file": "txt", "csv": "csv", "json": "json"}


def fs_program(pw, root, fmt: str, with_metadata: bool) -> dict:
    """``pw.io.fs.read`` of ``root``'s directory for ``fmt`` in static mode."""
    import os

    schema = None
    if fmt in ("csv", "json"):
        cols = {"name": str, "qty": int}
        if fmt == "json":
            cols["tags"] = pw.Json
        schema = pw.schema_from_types(**cols)
    t = pw.io.fs.read(os.path.join(root, FS_FORMATS[fmt]), format=fmt, schema=schema, mode="static",
                      with_metadata=with_metadata)
    return {"read": t}


class Subject:
    """A ``ConnectorSubject`` program: rows over three commits, a removal
    by primary key, ``next_json`` and ``next_str``."""

    @staticmethod
    def make(pw):
        class Rows(pw.io.python.ConnectorSubject):
            def run(self):
                for i in range(4):
                    self.next(k=i, v=float(i) / 3, data=f"row {i}")
                self.commit()
                self._remove(None, {"k": 1, "v": 1 / 3, "data": "row 1"})
                self.next_json({"k": 7, "v": 2.5, "data": "json"})
                self.commit()
                self.next(k=8, v=0.1, data="late")
                self.commit()
                self.close()

        class Schema(pw.Schema):
            k: int = pw.column_definition(primary_key=True)
            v: float
            data: str

        return pw.io.python.read(Rows(), schema=Schema)


def subscribe_run(pw, table) -> list:
    """Run ``table`` through ``pw.io.subscribe`` and ``pw.run``: the calls
    of ``on_change``, ``on_time_end`` and ``on_end`` in order, canonical."""
    calls: list = []
    pw.io.subscribe(
        table,
        on_change=lambda key, row, time, is_addition: calls.append(
            ("change", int(key.value), canon(tuple(row.items())), time, is_addition)),
        on_time_end=lambda time: calls.append(("time_end", time)),
        on_end=lambda: calls.append(("end",)),
    )
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    return calls


def index_program(pw, metric: str, inner: str, n_data: int = 40, dim: int = 8, seed: int = SEED + 20) -> dict:
    """``DataIndex`` over ``BruteForceKnn`` (``metric``) or ``LshKnn``: a
    data table that gains and loses rows over three epochs, and queries
    with a per-query ``k`` and a metadata filter at two times.  Returns
    the ``query_as_of_now`` and ``query`` tables, collapsed and not."""
    idx = sub(pw, "stdlib.indexing")
    rng = np.random.default_rng(seed)

    class Data(pw.Schema):
        name: str
        vec: np.ndarray
        meta: pw.Json

    class Query(pw.Schema):
        qvec: np.ndarray
        k: int
        filt: str | None

    vecs = rng.normal(size=(n_data + 8, dim)).astype(np.float32)
    rows = [(f"d{i}", vecs[i], pw.Json({"group": i % 3, "path": f"/docs/d{i}.txt"}), 2 if i < 30 else 4, 1)
            for i in range(n_data)]
    rows += [(f"d{i}", vecs[i], pw.Json({"group": i % 3, "path": f"/docs/d{i}.txt"}), 6, -1) for i in range(0, 10, 2)]
    data = pw.debug.table_from_rows(Data, rows, is_stream=True)
    filters = [None, "group == 1", "globmatch('/docs/d1*', path)", None, "group > 0 && group < 2", None]
    qrows = [(vecs[n_data + j], int(rng.integers(1, 6)), filters[j], 2 if j < 4 else 4, 1) for j in range(6)]
    queries = pw.debug.table_from_rows(Query, qrows, is_stream=True)
    if inner == "lsh":
        index = idx.DataIndex(data, idx.LshKnn(data.vec, data.meta, dimensions=dim, n_or=6, n_and=2))
    else:
        index = idx.DataIndex(data, idx.BruteForceKnn(data.vec, data.meta, metric=idx.DistanceMetric[metric],
                                                      **port_kw(pw)))
    out = {}
    for method in ("query_as_of_now", "query"):
        for collapse in (True, False):
            res = getattr(index, method)(queries.qvec, number_of_matches=queries.k, metadata_filter=queries.filt,
                                         collapse_rows=collapse)
            out[f"{method}:{collapse}"] = res.without(*[c for c in res.column_names() if c in ("vec", "qvec")])
    return out


def hybrid_index_program(pw, dense: str, n_data: int = 36, seed: int = SEED + 30) -> dict:
    """``DataIndex`` over ``HybridIndex([dense, TantivyBM25])`` on one text
    column, ``dense`` a ``BruteForceKnn`` or a ``USearchKnn`` over the mock
    embedder: the data gains and loses rows over three epochs, queries carry
    their own ``k`` and a metadata filter.  Returns ``query_as_of_now`` and
    ``query``, collapsed and not."""
    idx = sub(pw, "stdlib.indexing")
    mocks = sub(pw, "xpacks.llm.mocks")
    rng = np.random.default_rng(seed)

    class Data(pw.Schema):
        text: str
        meta: pw.Json

    class Query(pw.Schema):
        q: str
        k: int
        filt: str | None

    texts = [" ".join(rng.choice(WORDS, size=int(rng.integers(2, 9)))) for _ in range(n_data + 6)]
    rows = [(texts[i], pw.Json({"group": i % 3}), 2 if i < 24 else 4, 1) for i in range(n_data)]
    rows += [(texts[i], pw.Json({"group": i % 3}), 6, -1) for i in range(0, 12, 3)]
    data = pw.debug.table_from_rows(Data, rows, is_stream=True)
    filters = [None, "group == 1", None, "group != 0", None, None]
    qrows = [(texts[n_data + j], int(rng.integers(1, 6)), filters[j], 2 if j < 3 else 4, 1) for j in range(6)]
    queries = pw.debug.table_from_rows(Query, qrows, is_stream=True)
    kw = {"embedder": mocks.fake_embeddings_model}
    if dense == "brute":
        inner = idx.BruteForceKnn(data.text, data.meta, **kw, **port_kw(pw))
    elif dense == "lsh":
        inner = idx.LshKnn(data.text, data.meta, dimensions=8, n_or=6, n_and=2, **kw)
    else:
        inner = idx.USearchKnn(data.text, data.meta, **kw)
    index = idx.DataIndex(data, idx.HybridIndex([inner, idx.TantivyBM25(data.text, data.meta)]))
    out = {}
    for method in ("query_as_of_now", "query"):
        for collapse in (True, False):
            out[f"{method}:{collapse}"] = getattr(index, method)(
                queries.q, number_of_matches=queries.k, metadata_filter=queries.filt, collapse_rows=collapse)
    return out


# ---------------------------------------------------------------------------
# the stdlib's small modules (tests/test_stdlib_misc.py's programs, and
# ml's): programs of either package
# ---------------------------------------------------------------------------


def _stream(pw, schema, rows):
    return pw.debug.table_from_rows(schema, rows, is_stream=True)


def _values(rng, n: int, times=(2, 4, 6)) -> list:
    """``n`` rows (k, v, t) of a stream: a key of three, a value, a time."""
    return [(str(rng.choice(["a", "b", "c"])), int(rng.integers(-20, 20)), int(rng.integers(0, 50)), int(t), 1)
            for t in rng.choice(times, size=n)]


def _hmm_graph():
    import functools

    import networkx as nx

    def emission(observation, state):
        table = {("HUNGRY", "GRUMPY"): 0.9, ("HUNGRY", "HAPPY"): 0.1, ("FULL", "GRUMPY"): 0.7,
                 ("FULL", "HAPPY"): 0.3}
        return np.log(table[(state, observation)])

    g = nx.DiGraph()
    for state in ("HUNGRY", "FULL"):
        g.add_node(state, calc_emission_log_ppb=functools.partial(emission, state=state))
    for a, b, p in (("HUNGRY", "HUNGRY", 0.4), ("HUNGRY", "FULL", 0.6), ("FULL", "HUNGRY", 0.6),
                    ("FULL", "FULL", 0.4)):
        g.add_edge(a, b, log_transition_ppb=np.log(p))
    g.graph["start_nodes"] = ["HUNGRY", "FULL"]
    return g


def stdlib_program(pw, name: str) -> dict:
    """The stdlib program ``name`` (a key of ``STDLIB_PROGRAMS``) in ``pw``."""
    rng = np.random.default_rng(SEED + 50 + sorted(STDLIB_PROGRAMS).index(name))
    std = sub(pw, "stdlib")
    kvt = pw.schema_from_types(k=str, v=int, t=int)
    if name == "deduplicate":
        t = _stream(pw, kvt, _values(rng, 30))
        return {"latest": std.stateful.deduplicate(t, value=pw.this.v, acceptor=lambda new, old: new > old),
                "method": t.deduplicate(value=pw.this.v),
                "instance": t.deduplicate(value=pw.this.v, instance=pw.this.k,
                                          acceptor=lambda new, old: abs(new) >= abs(old))}
    if name == "interpolate":
        xs = rng.choice(40, size=16, replace=False)
        rows = [(int(x), None if rng.random() < 0.4 else float(rng.normal()), 2 if i < 10 else 4, 1)
                for i, x in enumerate(xs)]
        t = _stream(pw, pw.schema_from_types(t=int, v=float | None), rows)
        return {"function": std.statistical.interpolate(t, pw.this.t, pw.this.v),
                "method": t.interpolate(pw.this.t, pw.this.v)}
    if name == "diff":
        rows = [(k, v, int(t_), tt, d) for (k, v, t_, tt, d) in _values(rng, 24)]
        t = _stream(pw, kvt, list({(r[0], r[2]): r for r in rows}.values()))
        return {"plain": std.ordered.diff(t, pw.this.t, pw.this.v),
                "instance": t.diff(pw.this.t, pw.this.v, instance=pw.this.k)}
    if name == "diff_columns":
        rows = [(int(t_), float(rng.normal()), int(rng.integers(0, 9)), tt, 1)
                for t_, tt in zip(rng.choice(60, size=14, replace=False), rng.choice((2, 4), size=14))]
        t = _stream(pw, pw.schema_from_types(t=int, x=float, n=int), rows)
        return {"both": t.diff(pw.this.t, pw.this.x, pw.this.n)}
    if name == "filtering":
        t = _stream(pw, kvt, _values(rng, 24))
        filt = sub(pw, "stdlib.utils.filtering")
        return {"argmax": filt.argmax_rows(t, pw.this.k, what=pw.this.v),
                "argmin": filt.argmin_rows(t, pw.this.k, what=pw.this.v)}
    if name == "col":
        t = _stream(pw, kvt, _values(rng, 12))
        packed = t.select(data=pw.make_tuple(pw.this.k, pw.this.v, pw.this.t))
        rep = t.select(k=pw.this.k, vals=pw.apply(lambda v: tuple(range(abs(v) % 4)), pw.this.v))
        return {"unpack": std.utils.unpack_col(packed.data, "key", "value", "time"),
                "flatten": std.utils.flatten_column(rep.vals)}
    if name == "async_transformer":
        import asyncio

        class Doubler(pw.AsyncTransformer):
            output_schema = pw.schema_from_types(doubled=int, tag=str)

            async def invoke(self, k, v, t) -> dict:
                await asyncio.sleep(0)
                if v == 13:
                    raise ValueError("dropped")
                return {"doubled": 2 * v + t, "tag": k.upper()}

        t = _stream(pw, kvt, _values(rng, 16, times=(2, 4)) + [("z", 13, 0, 2, 1)])
        return {"successful": Doubler(t).successful}
    if name == "pandas_transformer":
        t = pw.debug.table_from_rows(kvt, [r[:3] for r in _values(rng, 10)])

        @pw.pandas_transformer(output_schema=pw.schema_from_types(k=str, s=int))
        def totals(df):
            grouped = df.groupby("k")["v"].sum()
            return grouped.reset_index().rename(columns={"v": "s"})

        return {"totals": totals(t)}
    if name == "knn_classifier":
        centers = {"low": (0.0, 0.0), "mid": (3.0, -2.0), "high": (6.0, 5.0)}
        data_rows, query_rows = [], []
        for label, c in centers.items():
            for _ in range(5):
                data_rows.append((tuple(float(x) for x in np.add(c, rng.normal(scale=0.3, size=2))), label))
            query_rows.append((tuple(float(x) for x in np.add(c, rng.normal(scale=0.3, size=2))),))
        data = pw.debug.table_from_rows(pw.schema_from_types(data=tuple, label=str), data_rows)
        queries = pw.debug.table_from_rows(pw.schema_from_types(data=tuple), query_rows)
        classify = std.ml.classifiers.knn_lsh_classifier_train(data, L=4, d=2, **port_kw(pw))
        cosine = std.ml.classifiers.knn_lsh_classifier_train(data, L=4, type="cosine", d=2, **port_kw(pw))
        return {"labels": classify(data, queries, k=3), "cosine": cosine(data, queries, k=1)}
    if name == "knn_index":
        dim = 6
        vecs = rng.normal(size=(30, dim)).astype(np.float32)
        drows = [(vecs[i], pw.Json({"g": i % 2}), 2 if i < 20 else 4, 1) for i in range(24)]
        drows += [(vecs[i], pw.Json({"g": i % 2}), 6, -1) for i in (1, 5)]
        data = _stream(pw, pw.schema_from_types(emb=np.ndarray, meta=pw.Json), drows)
        qs = _stream(pw, pw.schema_from_types(q=np.ndarray, filt=str | None),
                     [(vecs[24 + j], [None, "g == 1"][j % 2], 2 if j < 3 else 4, 1) for j in range(6)])
        index = std.ml.index.KNNIndex(data.emb, data, n_dimensions=dim, distance_type="cosine",
                                      metadata=data.meta, **port_kw(pw))
        return {"nearest": index.get_nearest_items(qs.q, k=3, metadata_filter=qs.filt).without("emb"),
                "asof_now": index.get_nearest_items_asof_now(qs.q, k=2, with_distances=True).without("emb")}
    if name == "fuzzy_match":
        left = pw.debug.table_from_rows(pw.schema_from_types(name=str),
                                        [(" ".join(rng.choice(WORDS, size=2)),) for _ in range(8)])
        right = pw.debug.table_from_rows(pw.schema_from_types(name=str),
                                         [(" ".join(rng.choice(WORDS, size=2)).upper(),) for _ in range(8)])
        return {"matches": std.ml.smart_table_ops.fuzzy_match_tables(left, right)}
    if name == "hmm":
        obs = _stream(pw, pw.schema_from_types(observation=str),
                      [(str(o), 2 + 2 * i, 1) for i, o in enumerate(rng.choice(["HAPPY", "GRUMPY"], size=6))])
        hmm = std.ml.hmm
        return {"kept": obs.reduce(decoded=pw.reducers.udf_reducer(
                    hmm.create_hmm_reducer(_hmm_graph(), num_results_kept=3))(pw.this.observation)),
                "beam": obs.reduce(decoded=pw.reducers.udf_reducer(
                    hmm.create_hmm_reducer(_hmm_graph(), beam_size=1))(pw.this.observation))}
    raise KeyError(name)


STDLIB_PROGRAMS = ("deduplicate", "interpolate", "diff", "diff_columns", "filtering", "col", "async_transformer",
                   "pandas_transformer", "knn_classifier", "knn_index", "fuzzy_match", "hmm")


# ---------------------------------------------------------------------------
# the temporal slice: windows, behaviors and time joins (tests/test_temporal*.py,
# tests/test_window_columnar.py), and pw.graphs (tests/test_graphs_iterate.py)
# ---------------------------------------------------------------------------

EPOCHS = (2, 4, 6, 8, 10)


def _timed(rng, n: int, span: int, offset: int = 0, late: float = 0.2) -> list:
    """``n`` (event time, epoch) pairs: event times grow with the epoch, each
    epoch covering ``span``, a share ``late`` of them two epochs behind."""
    out = []
    for _ in range(n):
        e = int(rng.integers(0, len(EPOCHS)))
        t = int(rng.integers(e * span, (e + 1) * span)) + offset
        if rng.random() < late:
            t -= 2 * span
        out.append((t, EPOCHS[e]))
    return out


def _events(pw, rng, n: int = 60, span: int = 12, offset: int = 0):
    """A stream (k, t, v) over ``EPOCHS`` with late rows, and a few rows
    retracted two epochs after they came."""
    rows = [(str(rng.choice(["a", "b", "c"])), t, int(rng.integers(-9, 10)), e, 1)
            for t, e in _timed(rng, n, span, offset)]
    rows += [(k, t, v, e + 4, -1) for k, t, v, e, _d in rows[::7] if e + 4 <= EPOCHS[-1]]
    return _stream(pw, pw.schema_from_types(k=str, t=int, v=int), rows)


def _reduce(pw, grouped):
    return grouped.reduce(start=pw.this._pw_window_start, end=pw.this._pw_window_end, n=pw.reducers.count(),
                          s=pw.reducers.sum(pw.this.v), lo=pw.reducers.min(pw.this.t), hi=pw.reducers.max(pw.this.t))


def temporal_program(pw, name: str) -> dict:
    """The temporal program ``name`` (a key of ``TEMPORAL_PROGRAMS``) in ``pw``."""
    rng = np.random.default_rng(SEED + 80 + TEMPORAL_PROGRAMS.index(name))
    tp = pw.temporal
    if name in ("tumbling", "sliding", "session"):
        t = _events(pw, rng, offset=-20 if name == "tumbling" else 0)
        w = {"tumbling": {"plain": tp.tumbling(10), "origin": tp.tumbling(7, origin=3), "shift": tp.tumbling(9, shift=3)},
             "sliding": {"branches": tp.sliding(hop=3, duration=9), "flatten": tp.sliding(hop=4, duration=10),
                         "ratio": tp.sliding(hop=5, ratio=2), "origin": tp.sliding(hop=4, duration=8, origin=1)},
             "session": {"gap": tp.session(max_gap=3), "predicate": tp.session(predicate=lambda a, b: b - a <= 2)}}[name]
        out = {k: _reduce(pw, t.windowby(t.t, window=win)) for k, win in w.items()}
        out.update({f"{k}:instance": _reduce(pw, t.windowby(t.t, window=win, instance=t.k)) for k, win in w.items()})
        return out
    if name == "intervals_over":
        t = _events(pw, rng)
        at = _stream(pw, pw.schema_from_types(at=int), [(int(a), e, 1) for a, e in _timed(rng, 6, 12, late=0)]
                     + [(100, 4, 1)])
        out = {}
        for outer in (True, False):
            win = tp.intervals_over(at=at.at, lower_bound=-5, upper_bound=5, is_outer=outer)
            out[f"outer:{outer}"] = t.windowby(t.t, window=win).reduce(
                at=pw.this._pw_window, n=pw.reducers.count(), s=pw.reducers.sum(pw.this.v))
        win = tp.intervals_over(at=at.at, lower_bound=-3, upper_bound=0)
        out["instance"] = t.windowby(t.t, window=win, instance=t.k).reduce(at=pw.this._pw_window, n=pw.reducers.count())
        return out
    if name == "datetime":
        base = datetime.datetime(2024, 5, 1, 9, 0)
        out = {}
        for kind, tz in (("utc", datetime.timezone.utc), ("naive", None)):
            rows = [(str(rng.choice(["a", "b"])), base.replace(tzinfo=tz) + datetime.timedelta(minutes=t), int(v), e, 1)
                    for (t, e), v in zip(_timed(rng, 40, 25), rng.integers(0, 9, 40))]
            typ = pw.DateTimeUtc if tz else pw.DateTimeNaive
            t = _stream(pw, pw.schema_from_types(k=str, t=typ, v=int), rows)
            minutes = datetime.timedelta(minutes=1)
            for wname, win in (("tumbling", tp.tumbling(10 * minutes)),
                               ("sliding", tp.sliding(hop=5 * minutes, duration=15 * minutes)),
                               ("session", tp.session(max_gap=7 * minutes))):
                out[f"{kind}:{wname}"] = _reduce(pw, t.windowby(t.t, window=win, instance=t.k))
        return out
    if name == "behaviors":
        t = _events(pw, rng, n=80, span=8)
        behaviors = {"delay": tp.common_behavior(delay=4), "cutoff": tp.common_behavior(cutoff=3),
                     "delay_cutoff": tp.common_behavior(delay=2, cutoff=5),
                     "forget": tp.common_behavior(cutoff=2, keep_results=False),
                     "exactly_once": tp.exactly_once_behavior(), "exactly_once_shift": tp.exactly_once_behavior(shift=3)}
        out = {k: _reduce(pw, t.windowby(t.t, window=tp.tumbling(10), instance=t.k, behavior=b))
               for k, b in behaviors.items()}
        out["sliding_delay_cutoff"] = _reduce(pw, t.windowby(t.t, window=tp.sliding(hop=4, duration=12),
                                                             behavior=tp.common_behavior(delay=3, cutoff=4)))
        out["session_cutoff"] = _reduce(pw, t.windowby(t.t, window=tp.session(max_gap=2),
                                                       behavior=tp.common_behavior(cutoff=6)))
        # a late row reaching an emitted window before the next one closes:
        # the exactly-once output revises it, in both packages
        late = _stream(pw, pw.schema_from_types(t=int, v=int), [(1, 1, 2, 1), (12, 1, 4, 1), (5, 1, 6, 1),
                                                               (25, 1, 8, 1)])
        out["exactly_once_late"] = _reduce(pw, late.windowby(late.t, window=tp.tumbling(10),
                                                             behavior=tp.exactly_once_behavior()))
        return out
    quotes = _stream(pw, pw.schema_from_types(qt=int, ticker=str, price=int),
                     [(t, str(rng.choice(["x", "y"])), int(rng.integers(90, 110)), e, 1)
                      for t, e in _timed(rng, 30, 10)])
    trades = _stream(pw, pw.schema_from_types(tt=int, ticker=str, qty=int),
                     [(t, str(rng.choice(["x", "y"])), int(rng.integers(1, 50)), e, 1)
                      for t, e in _timed(rng, 24, 10)] + [(13, "x", 7, 4, 1), (13, "x", 7, 8, -1)])
    if name == "asof_join":
        out = {}
        for d in ("BACKWARD", "FORWARD", "NEAREST"):
            direction = tp.Direction[d]
            out[d] = trades.asof_join(quotes, trades.tt, quotes.qt, trades.ticker == quotes.ticker,
                                      direction=direction).select(trades.tt, trades.qty, quotes.price)
        out["left_defaults"] = tp.asof_join_left(trades, quotes, trades.tt, quotes.qt, trades.ticker == quotes.ticker,
                                                 defaults={quotes.price: -1}).select(trades.tt, quotes.price)
        out["right"] = trades.asof_join_right(quotes, trades.tt, quotes.qt).select(quotes.qt, trades.qty)
        out["outer"] = trades.asof_join_outer(quotes, trades.tt, quotes.qt, trades.ticker == quotes.ticker).select(
            trades.tt, quotes.price)
        out["unkeyed"] = tp.asof_join(trades, quotes, trades.tt, quotes.qt).select(trades.qty, quotes.price)
        return out
    if name == "interval_join":
        iv = tp.interval(-3, 2)
        out = {}
        for how in ("interval_join", "interval_join_left", "interval_join_right", "interval_join_outer"):
            out[how] = getattr(trades, how)(quotes, trades.tt, quotes.qt, iv, trades.ticker == quotes.ticker).select(
                trades.tt, trades.qty, quotes.qt, quotes.price)
        out["unkeyed"] = tp.interval_join(trades, quotes, trades.tt, quotes.qt, tp.interval(0, 1)).select(
            trades.qty, quotes.price)
        return out
    if name == "window_join":
        out = {}
        for how in ("window_join", "window_join_left", "window_join_right", "window_join_outer"):
            fn = trades.window_join if how == "window_join" else functools.partial(getattr(tp, how), trades)
            out[how] = fn(quotes, trades.tt, quotes.qt, tp.tumbling(8), trades.ticker == quotes.ticker).select(
                trades.tt, trades.qty, quotes.qt, quotes.price)
        out["sliding"] = tp.window_join(trades, quotes, trades.tt, quotes.qt, tp.sliding(hop=3, duration=6)).select(
            trades.qty, quotes.price)
        return out
    if name == "asof_now_join":
        rows = [(k, int(rng.integers(0, 99)), e, 1) for k, e in zip("abcab", (2, 2, 4, 6, 8))]
        data = _stream(pw, pw.schema_from_types(k=str, v=int), rows + [(*rows[0][:2], 6, -1)])
        queries = _stream(pw, pw.schema_from_types(qk=str), [(str(rng.choice(list("abcd"))), e, 1)
                                                             for e in (2, 4, 4, 6, 8, 8, 10)] + [("a", 10, -1)])
        return {"inner": queries.asof_now_join(data, queries.qk == data.k).select(queries.qk, data.v),
                "left": tp.asof_now_join_left(queries, data, queries.qk == data.k).select(queries.qk, data.v)}
    raise KeyError(name)


TEMPORAL_PROGRAMS = ("tumbling", "sliding", "session", "intervals_over", "datetime", "behaviors", "asof_join",
                     "interval_join", "window_join", "asof_now_join")


def graph_program(pw, name: str) -> dict:
    """The ``pw.graphs`` program ``name`` (a key of ``GRAPH_PROGRAMS``) in ``pw``."""
    rng = np.random.default_rng(SEED + 95 + GRAPH_PROGRAMS.index(name))
    names = [f"v{i}" for i in range(10)]
    edge_s = pw.schema_from_types(u=str, v=str)
    if name == "pagerank":
        edges = [(str(rng.choice(names)), str(rng.choice(names))) for _ in range(24)]
        static = pw.debug.table_from_rows(edge_s, list(dict.fromkeys((u, v) for u, v in edges if u != v)))
        grown = _stream(pw, edge_s, [("A", "B", 2, 1), ("B", "A", 2, 1), ("C", "B", 4, 1), ("D", "C", 6, 1),
                                     ("C", "B", 8, -1)])
        return {"random": pw.graphs.pagerank(static, steps=20), "incremental": pw.graphs.pagerank(grown, steps=50)}
    if name == "bellman_ford":
        class Vertex(pw.Schema):
            name: str = pw.column_definition(primary_key=True)
            is_source: bool

        vertices = pw.debug.table_from_rows(Vertex, [(n, n == "v0") for n in names])
        pairs = {(str(rng.choice(names)), str(rng.choice(names))) for _ in range(20)}
        labeled = _stream(pw, pw.schema_from_types(lu=str, lv=str, dist=float),
                          [(u, v, float(rng.integers(1, 9)), 2 if i % 3 else 4, 1) for i, (u, v) in enumerate(sorted(pairs))])
        edges = labeled.select(u=vertices.pointer_from(pw.this.lu), v=vertices.pointer_from(pw.this.lv),
                               dist=pw.this.dist)
        return {"distances": pw.graphs.bellman_ford(vertices, edges, iteration_limit=12)}
    if name == "louvain":
        cliques = [(f"{c}{i}", f"{c}{j}") for c in "ab" for i in range(3) for j in range(i + 1, 3)]
        edges = pw.debug.table_from_rows(edge_s, cliques + [("a0", "b0")])
        return {"two_cliques": pw.graphs.louvain_level(edges, iteration_limit=10)}
    raise KeyError(name)


GRAPH_PROGRAMS = ("pagerank", "bellman_ford", "louvain")
SUITES = {"temporal": (TEMPORAL_PROGRAMS, temporal_program), "graphs": (GRAPH_PROGRAMS, graph_program)}


def capture_suite(pw, suite: str) -> dict:
    names, program = SUITES[suite]
    return {name: capture(pw, program(pw, name)) for name in names}


def capture_suite_paths(pw, suite: str) -> dict:
    """``{columnar: capture_suite(pw, suite)}`` on the columnar path and the
    row path of ``pw``."""
    compiler = sub(pw, "internals.vector_compiler")
    out = {}
    for columnar in (True, False):
        compiler.set_enabled(columnar)
        try:
            out[columnar] = capture_suite(pw, suite)
        finally:
            compiler.set_enabled(True)
            pw.G.clear()
    return out


def spawn_python_core(out, *args) -> subprocess.Popen:
    """This module as a script (``OUT *args``) under ``PATHWAY_NATIVE=0``:
    the port's pure-Python core."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATHWAY_NATIVE="0", PYTHONPATH=repo)
    return subprocess.Popen([sys.executable, "-m", "tests.torch_dataflow_programs", str(out), *args], cwd=repo,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def python_core_result(proc: subprocess.Popen, out) -> dict:
    """What ``spawn_python_core`` captured, once it has ended cleanly on
    the pure-Python core."""
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-3000:]
    with open(out, "rb") as f:
        got = pickle.load(f)
    assert got["native_loaded"] is False
    return got


def doctest_failures(pw, module: str) -> int:
    """Run the ``>>>`` examples of ``pw``'s module ``module`` (the ones the
    port carries over from the JAX package's); the number that failed.
    Fails if the module has none."""
    import doctest

    mod = sub(pw, module)
    tests = [t for t in doctest.DocTestFinder(exclude_empty=True).find(mod) if t.examples]
    assert tests, module
    runner = doctest.DocTestRunner(optionflags=doctest.NORMALIZE_WHITESPACE)
    for test in tests:
        pw.G.clear()
        runner.run(test)
    pw.G.clear()
    return runner.failures


def _capture_port_paths(out: str, model_dir: str | None = None, params_path: str | None = None) -> None:
    """Every program of the port, one suite of ``SUITES`` (``model_dir``
    naming it) or the embedding program alone, with the columnar path on
    and off."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch import native
    from pathway_tpu_torch.device import get_default_executor
    from pathway_tpu_torch.internals import vector_compiler as vc

    enc = None
    suite = model_dir if model_dir in SUITES else None
    if model_dir is not None and suite is None:
        with open(params_path, "rb") as f:
            enc = port_encoder(model_dir, pickle.load(f))
    got = {"native_loaded": native.get() is not None}
    for columnar in (True, False):
        vc.set_enabled(columnar)
        if suite is not None:
            got[columnar] = capture_suite(pw, suite)
        elif enc is None:
            got[columnar] = {name: capture_program(pw, name) for name in PROGRAMS}
        else:
            got[columnar] = {"embedding": capture_embedding(pw, enc.encode, enc.dimensions,
                                                            executor=get_default_executor("cpu"))}
    with open(out, "wb") as f:
        pickle.dump(got, f)


if __name__ == "__main__":
    _capture_port_paths(*sys.argv[1:])

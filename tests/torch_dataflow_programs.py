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
its rows are held with tolerances where they carry vectors.

Run as a script (``python -m tests.torch_dataflow_programs OUT [MODEL_DIR
PARAMS]``), it captures every program of the port into the pickle ``OUT``
under the environment it was started in, with the columnar path on and
off; given the encoder's config directory and its weights (a pickle of
numpy arrays), the embedding program alone.  The parity tests start it
with ``PATHWAY_NATIVE=0`` for the pure-Python core.
"""

from __future__ import annotations

import asyncio
import datetime
import pickle
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
    import importlib

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


def _capture_port_paths(out: str, model_dir: str | None = None, params_path: str | None = None) -> None:
    """Every program of the port (or the embedding program alone) with the
    columnar path on and off."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch import native
    from pathway_tpu_torch.device import get_default_executor
    from pathway_tpu_torch.internals import vector_compiler as vc

    enc = None
    if model_dir is not None:
        with open(params_path, "rb") as f:
            enc = port_encoder(model_dir, pickle.load(f))
    got = {"native_loaded": native.get() is not None}
    for columnar in (True, False):
        vc.set_enabled(columnar)
        if enc is None:
            got[columnar] = {name: capture_program(pw, name) for name in PROGRAMS}
        else:
            got[columnar] = {"embedding": capture_embedding(pw, enc.encode, enc.dimensions,
                                                            executor=get_default_executor("cpu"))}
    with open(out, "wb") as f:
        pickle.dump(got, f)


if __name__ == "__main__":
    _capture_port_paths(*sys.argv[1:])

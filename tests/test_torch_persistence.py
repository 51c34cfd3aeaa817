"""The port's persistence held to the JAX package's on one worker.

Each case runs one program of ``tests/torch_persistence_programs.py`` with
stop and resume on a persistence root in both packages, holds the port's
change streams to the JAX package's (keys, rows and diffs; a connector's
epochs follow its reader thread, so not times), and both to the outcome
``tests/test_persistence.py`` and ``tests/test_operator_persistence.py``
pin: input snapshots (fs, appended file, Python subject, mock backend),
``UDF_CACHING``, the refusals, operator snapshots (no input replay,
bounded replay, join and deduplicate state, a changed graph), the UDF
``DiskCache`` and the file reader's resume from a persisted frontier.
"""

from __future__ import annotations

import os

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from tests import torch_persistence_programs as progs
from tests.torch_dataflow_programs import sub

PACKAGES = (jpw, tpw)


@pytest.fixture(autouse=True)
def clean_graphs():
    for pw in PACKAGES:
        pw.G.clear()
    yield
    for pw in PACKAGES:
        pw.G.clear()


def write(path, text: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def both(tmp_path, program, steps):
    """``program(pw, dirs...)`` per step, in each package on its own input
    and root: ``steps`` is ``[(files to write, kwargs)]``; returns each
    package's list of change streams, the port's held to JAX's."""
    streams = {}
    for pw in PACKAGES:
        base = tmp_path / pw.__name__
        runs = []
        for files, kwargs in steps:
            for name, text in files.items():
                write(str(base / "input" / name), text)
            runs.append(program(pw, base / "input", base / "pstore", **kwargs))
        streams[pw.__name__] = runs
    for jax_run, port_run in zip(streams["pathway_tpu"], streams["pathway_tpu_torch"]):
        assert progs.untimed(port_run) == progs.untimed(jax_run)
    return streams["pathway_tpu_torch"]


def counts(changes) -> dict:
    return {row[0][1][1]: row[1][1][1] for row in progs.final(changes).values()}


@pytest.mark.parametrize("mode", [None, "OPERATOR_PERSISTING"])
def test_fs_resume_without_duplicates(tmp_path, mode):
    runs = both(tmp_path, progs.words, [({"a.csv": "word\nfoo\nbar\nfoo\n"}, {"mode": mode}),
                                        ({"b.csv": "word\nfoo\nbaz\n"}, {"mode": mode})])
    assert counts(runs[0]) == {"foo": 2, "bar": 1}
    if mode is None:
        assert counts(runs[1]) == {"foo": 3, "bar": 1, "baz": 1}
    else:
        # operator snapshots: run 2 emits only the delta, and its first
        # change for 'foo' retracts the restored count
        assert counts(runs[1]) == {"foo": 3, "baz": 1}
        assert progs.values(runs[1], "word", "n")[0] == ("foo", 2, False)


def test_appended_file_resume(tmp_path):
    streams = {}
    for pw in PACKAGES:
        base = tmp_path / pw.__name__
        path = str(base / "input" / "a.csv")
        write(path, "word\nfoo\n")
        first = progs.words(pw, base / "input", base / "pstore")
        with open(path, "a") as f:
            f.write("bar\n")
        os.utime(path, (os.path.getmtime(path) + 5,) * 2)
        streams[pw.__name__] = (first, progs.words(pw, base / "input", base / "pstore"))
    for j, t in zip(streams["pathway_tpu"], streams["pathway_tpu_torch"]):
        assert progs.untimed(t) == progs.untimed(j)
    assert counts(streams["pathway_tpu_torch"][1]) == {"foo": 1, "bar": 1}


def test_python_subject_resume(tmp_path):
    runs = both(tmp_path, lambda pw, _inp, root: progs.subject_sum(pw, root), [({}, {}), ({}, {})])
    assert progs.values(runs[0], "total")[-1] == (100, True)
    # the row-count frontier skips the 5 re-emitted rows: one total, once
    assert [v for v, add in progs.values(runs[1], "total") if add] == [100]


def test_mock_backend_resume(tmp_path):
    streams = {}
    for pw in PACKAGES:
        store: dict = {}
        streams[pw.__name__] = [progs.subject_count(pw, store, 0, 3), progs.subject_count(pw, store, 0, 5)]
    for j, t in zip(streams["pathway_tpu"], streams["pathway_tpu_torch"]):
        assert progs.untimed(t) == progs.untimed(j)
    runs = streams["pathway_tpu_torch"]
    assert progs.values(runs[0], "n")[-1] == (3, True)
    assert [n for n, add in progs.values(runs[1], "n") if add][-1] == 5


def test_udf_caching_skips_input_snapshots():
    for pw in PACKAGES:
        store: dict = {}
        runs = [progs.subject_rows(pw, store, [{"k": 1}], mode="UDF_CACHING") for _ in range(2)]
        assert [progs.values(r, "k") for r in runs] == [[(1, True)]] * 2
        assert not any(k.startswith("snapshots/") for k in store)


def test_refusals_match_jax(tmp_path):
    for pw in PACKAGES:
        root = tmp_path / pw.__name__

        def source(name):
            return pw.io.python.read(progs.subject(pw, [{"k": 1}]), schema=pw.schema_from_types(k=int), name=name)

        progs.subscribe(pw, source("dup"))
        progs.subscribe(pw, source("dup"))
        with pytest.raises(ValueError, match="duplicate source name"):
            pw.run(persistence_config=progs.config(pw, root / "dup"))
        pw.G.clear()
        progs.subject_rows(pw, root / "schema", [{"k": 1}])
        with pytest.raises(ValueError, match="different schema"):
            progs.subject_rows(pw, root / "schema", [{"other": "x"}], schema=pw.schema_from_types(other=str))


def test_negative_user_key_persists(tmp_path):
    streams = [progs.subject_rows(pw, tmp_path / pw.__name__, [{"k": 5, "_pw_key": -1}]) for pw in PACKAGES]
    assert progs.untimed(streams[1]) == progs.untimed(streams[0])
    assert progs.values(streams[1], "k") == [(5, True)]


def spy(monkeypatch, pw, dotted: str, attr: str, record: list, result: bool):
    """Wrap ``<module>.<class>.<attr>`` of ``pw`` so each call's result (or
    its first argument after self) lands in ``record``."""
    module, cls_name = dotted.rsplit(".", 1)
    cls = getattr(sub(pw, module), cls_name)
    orig = getattr(cls, attr)

    def wrapped(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        record.append(out if result else args[0])
        return out

    monkeypatch.setattr(cls, attr, wrapped)


def test_operator_resume_without_input_replay(tmp_path, monkeypatch):
    replayed = {pw.__name__: [] for pw in PACKAGES}
    for pw in PACKAGES:
        base = tmp_path / pw.__name__
        write(str(base / "input" / "a.csv"), "word\nfoo\nbar\nfoo\n")
        progs.words(pw, base / "input", base / "pstore", "OPERATOR_PERSISTING")
        keys = sub(pw, "engine.persistence").FileBackend(str(base / "pstore")).list_keys("")
        assert any(k.startswith("operators/") for k in keys) and not any(k.startswith("snapshots/") for k in keys)
        spy(monkeypatch, pw, "engine.persistence.PersistentStorage", "replay_into", replayed[pw.__name__], True)
    runs = both(tmp_path, progs.words, [({"b.csv": "word\nfoo\nbaz\n"}, {"mode": "OPERATOR_PERSISTING"})])
    assert counts(runs[0]) == {"foo": 3, "baz": 1}
    assert not any(w == "bar" for w, _n, _a in progs.values(runs[0], "word", "n"))
    assert replayed == {"pathway_tpu": [0], "pathway_tpu_torch": [0]}  # O(state) resume


def test_bounded_replay_on_churny_stream(tmp_path, monkeypatch):
    churn = "word\n" + "\n".join(f"w{i % 5}" for i in range(1000))
    inserted = {}
    for pw in PACKAGES:
        base = tmp_path / pw.__name__
        write(str(base / "input" / "a.csv"), churn)
        first = progs.words(pw, base / "input", base / "pstore", "OPERATOR_PERSISTING")
        assert counts(first) == {f"w{i}": 200 for i in range(5)}
        inserted[pw.__name__] = []
        spy(monkeypatch, pw, "engine.dataflow.InputNode", "insert", inserted[pw.__name__], False)
    runs = both(tmp_path, progs.words, [({"b.csv": "word\nw0\n"}, {"mode": "OPERATOR_PERSISTING"})])
    assert counts(runs[0])["w0"] == 201
    assert {name: len(rows) for name, rows in inserted.items()} == {"pathway_tpu": 1, "pathway_tpu_torch": 1}


def test_join_state_restored(tmp_path):
    runs = both(tmp_path, progs.join_agg, [({"a.csv": "k,v\n1,x\n"}, {}), ({"b.csv": "k,v\n1,y\n"}, {})])
    assert ("x", ("tuple", (("str", "x"),)), True) in [
        (v, vs, add) for v, vs, add in [(dict(r)["v"][1], dict(r)["vs"], a) for _k, r, _t, a in runs[0]]]
    final = {dict(row)["v"][1]: dict(row)["vs"] for row in progs.final(runs[1]).values()}
    xy = ("tuple", (("str", "x"), ("str", "y")))
    assert final == {"x": xy, "y": xy}


def test_deduplicate_state_restored(tmp_path):
    runs = both(tmp_path, progs.increasing, [({"a.csv": "v\n5\n"}, {}), ({"b.csv": "v\n3\n"}, {}),
                                             ({"c.csv": "v\n9\n"}, {})])
    assert progs.values(runs[0], "v") == [(5, True)]
    assert runs[1] == []  # lower than the restored 5: rejected
    assert sorted(progs.values(runs[2], "v")) == [(5, False), (9, True)]


def test_graph_change_rejected(tmp_path):
    for pw in PACKAGES:
        base = tmp_path / pw.__name__
        write(str(base / "input" / "a.csv"), "v\n1\n")
        progs.total(pw, base / "input", base / "pstore")
        with pytest.raises(ValueError, match="graph changed"):
            progs.total(pw, base / "input", base / "pstore", extra_op=True)
        pw.G.clear()
        # the same graph again resumes
        assert progs.total(pw, base / "input", base / "pstore") == []


def test_disk_cache_calls_once_per_distinct_text(tmp_path):
    # distinct within a run: an epoch awaits its rows concurrently, so a
    # text twice in one epoch misses the cache twice, in both packages
    texts = ["alpha beta", "gamma", "delta eps", "zeta"]
    more = texts + ["eta theta"]
    got = {}
    for pw in PACKAGES:
        root = tmp_path / pw.__name__
        calls: list = []
        first = progs.cached_embeddings(pw, texts, root, calls)
        n_first = len(calls)
        second = progs.cached_embeddings(pw, more, root, calls)
        assert sorted(calls[:n_first]) == sorted(texts)
        assert calls[n_first:] == ["eta theta"]  # every other text is a cache hit
        assert os.listdir(root / "udf_cache" / "default")
        got[pw.__name__] = (progs.untimed(first), progs.untimed(second))
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]


def test_disk_cache_stores_tensors_as_host_arrays(tmp_path, monkeypatch):
    import numpy as np
    import torch

    monkeypatch.setenv("PATHWAY_PERSISTENT_STORAGE", str(tmp_path))
    cache = tpw.udfs.DiskCache("tensors")
    calls = []

    def embed(x):
        calls.append(x)
        return torch.full((3,), x + 0.5, dtype=torch.bfloat16)

    wrapped = cache.wrap(embed)
    miss, hit = wrapped(1.0), wrapped(1.0)
    assert calls == [1.0]
    for value in (miss, hit):
        assert isinstance(value, np.ndarray) and str(value.dtype) == "bfloat16"
        assert value.astype(np.float32).tolist() == [1.5] * 3
    assert cache._dir == str(tmp_path / "udf_cache" / "tensors")


def test_file_reader_resumes_from_frontier_like_jax(tmp_path):
    """A streaming file reader seeked to a persisted frontier reads an
    appended file on from its consumed units, in both packages: the port's
    streaming reader (which otherwise holds each file to a digest of the
    rows it emitted) re-emitted the whole file before."""
    path = tmp_path / "a.jsonl"
    path.write_text('{"w": "foo"}\n{"w": "bar"}\n')
    first = sub(jpw, "io._file_readers").FileReader(str(tmp_path), sub(jpw, "io._file_readers").jsonlines_parse_file,
                                                      streaming=True, object_pattern="*.jsonl")
    first._emit_file(str(path), lambda item: None)
    frontier = first._offset().value
    with open(path, "a") as f:
        f.write('{"w": "baz"}\n')
    os.utime(path, (os.path.getmtime(path) + 5,) * 2)
    emitted = {}
    for pw in PACKAGES:
        readers = sub(pw, "io._file_readers")
        reader = readers.FileReader(str(tmp_path), readers.jsonlines_parse_file, streaming=True,
                                    object_pattern="*.jsonl")
        reader.seek(frontier)
        out: list = []
        reader._emit_file(str(path), out.append)
        emitted[pw.__name__] = (out, reader._offset().value)
    assert emitted["pathway_tpu_torch"] == emitted["pathway_tpu"]
    assert emitted["pathway_tpu"][0] == [{"w": "baz"}]


def test_replay_storage_env_persists(tmp_path, monkeypatch):
    """``PATHWAY_REPLAY_STORAGE`` alone turns persistence on (record/replay)."""
    streams = {}
    for pw in PACKAGES:
        root = tmp_path / pw.__name__
        monkeypatch.setenv("PATHWAY_REPLAY_STORAGE", str(root))
        sub(pw, "internals.config").refresh_config()
        runs = []
        for _ in range(2):
            t = pw.io.python.read(progs.subject(pw, [{"k": i} for i in range(4)]), schema=pw.schema_from_types(k=int),
                                  name="s")
            seen = progs.subscribe(pw, t.reduce(n=pw.reducers.count()))
            pw.run(monitoring_level=pw.MonitoringLevel.NONE)
            pw.G.clear()
            runs.append(seen)
        assert os.path.isdir(root / "manifests")
        streams[pw.__name__] = [progs.untimed(r) for r in runs]
    monkeypatch.delenv("PATHWAY_REPLAY_STORAGE")
    for pw in PACKAGES:
        sub(pw, "internals.config").refresh_config()
    assert streams["pathway_tpu_torch"] == streams["pathway_tpu"]

"""The port's connectors held to the JAX package's.

Each program of ``tests/torch_dataflow_programs.py`` runs in both packages
on the same files or subject, and the changes are compared with ``==``:
keys, rows (float bits) and diffs.  A connector's rows are stamped on its
reader thread, and the runner closes an epoch with the rows staged when it
polls, so the epoch a row lands in follows the threads' pace in both
packages: times are held to be increasing, not equal.  File metadata's
``seen_at`` reads the wall clock, so both packages' ``_file_readers`` read
a pinned one.  A streaming run is compared by its final state and its
retraction/insert pairs.
"""

from __future__ import annotations

import json
import os
import threading
import time

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from tests import torch_dataflow_programs as progs

PACKAGES = (jpw, tpw)


@pytest.fixture(autouse=True)
def clean_graphs(monkeypatch):
    for pw in PACKAGES:
        monkeypatch.setattr(progs.sub(pw, "io._file_readers"), "_time", progs.PinnedClock)
        pw.G.clear()
    yield
    for pw in PACKAGES:
        pw.G.clear()


@pytest.mark.parametrize("with_metadata", [False, True])
@pytest.mark.parametrize("fmt", sorted(progs.FS_FORMATS))
def test_fs_static_read_matches_jax(tmp_path, fmt, with_metadata):
    progs.write_corpus(tmp_path, progs.SEED + 30)
    got = [progs.capture(pw, progs.fs_program(pw, tmp_path, fmt, with_metadata))["read"] for pw in PACKAGES]
    assert got[0], fmt
    assert untimed(got[1]) == untimed(got[0])


@pytest.mark.parametrize("fmt", ["csv", "jsonlines"])
def test_write_matches_jax(tmp_path, fmt):
    progs.write_corpus(tmp_path, progs.SEED + 31)
    outs = []
    for pw in PACKAGES:
        t = progs.fs_program(pw, tmp_path, "csv", False)["read"]
        out = tmp_path / f"{pw.__name__}.{fmt}"
        getattr(pw.io, fmt).write(t.select(pw.this.name, double=pw.this.qty * 2), str(out))
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        pw.G.clear()
        lines = out.read_text().splitlines()
        if fmt == "csv":  # the header, then rows of the columns, time and diff
            outs.append([lines[0]] + sorted(ln.rsplit(",", 2)[::2] for ln in lines[1:]))
        else:
            outs.append(sorted(sorted((k, v) for k, v in json.loads(ln).items() if k != "time") for ln in lines))
    assert len(outs[0]) > 3
    assert outs[1] == outs[0]


def untimed(stream) -> list:
    """A captured stream ``[(time, key, diff, row)]`` as sorted
    ``(key, diff, row)``."""
    return sorted((k, d, r) for _t, k, d, r in stream)


def calls_checked(calls) -> list:
    """``subscribe``'s calls in a form equal across the two packages: the
    changes sorted without their times, after checking that ``on_end``
    came last and each change's time is one ``on_time_end`` announced
    after it, in increasing order."""
    assert calls[-1] == ("end",)
    ends = [c[1] for c in calls if c[0] == "time_end"]
    assert ends == sorted(set(ends))
    pending = []
    for c in calls[:-1]:
        if c[0] == "change":
            pending.append(c[3])
        else:
            assert all(t == c[1] for t in pending), (pending, c)
            pending = []
    assert not pending
    return sorted((c[1], c[2], c[4]) for c in calls if c[0] == "change")


def test_python_subject_and_subscribe_match_jax():
    got = [calls_checked(progs.subscribe_run(pw, progs.Subject.make(pw))) for pw in PACKAGES]
    assert len(got[0]) == 7 and sum(1 for c in got[0] if not c[2]) == 1  # 6 inserts, the removal
    assert got[1] == got[0]


class Budget:
    """A reader that raises ``fails`` times in a row after emitting
    ``before`` rows, then emits all ``rows`` rows; it allows ``budget``
    consecutive errors."""

    @staticmethod
    def table(pw, budget: int, fails: int, before: int = 2, rows: int = 5):
        utils = progs.sub(pw, "io._utils")

        class Flaky(utils.Reader):
            max_allowed_consecutive_errors = budget

            def __init__(self):
                self.failed = 0

            def run(self, emit):
                for i in range(rows):
                    if i == before and self.failed < fails:
                        self.failed += 1
                        raise OSError(f"flaky read {self.failed}")
                    emit({"i": i})
                emit(utils.COMMIT)

        return utils.make_input_table(pw.schema_from_types(i=int), Flaky)


# a failure after rows were emitted resets the count: (2, 3, 2) restarts
# three times and finishes
@pytest.mark.parametrize("budget,fails,before,outcome",
                         [(0, 1, 2, "failed"), (2, 2, 0, "ok"), (2, 3, 0, "failed"), (2, 3, 2, "ok")])
def test_reader_error_budget_matches_jax(budget, fails, before, outcome):
    got = []
    for pw in PACKAGES:
        try:
            got.append(("ok", calls_checked(progs.subscribe_run(pw, Budget.table(pw, budget, fails, before)))))
        except Exception as exc:  # noqa: BLE001 - the two packages' EngineError
            got.append(("failed", type(exc).__name__, str(exc)))
        pw.G.clear()
    assert got[0][0] == outcome
    assert got[1] == got[0]


class StopRun(Exception):
    """Ends a streaming run from its ``on_change`` (both packages' runs
    re-raise it)."""


def streaming_run(pw, root, fmt: str = "binary", steps=None) -> dict:
    """``fs.read`` of ``root`` in streaming mode while a thread makes its
    ``steps`` (by default: adds a file, then rewrites one and deletes
    another); once the last change has had time to show it writes
    ``z.txt``, and the run ends by ``StopRun`` from ``on_change`` at that
    file's row.  Returns the deltas ``(key, row, diff)`` in order, each
    with its file's name."""
    deltas: list = []
    t = pw.io.fs.read(str(root), format=fmt, mode="streaming", with_metadata=True,
                      autocommit_duration_ms=20)

    def on_change(key, row, time, is_addition):
        name = row["_metadata"].value["path"].rsplit("/", 1)[1]
        deltas.append((int(key.value), name, progs.canon((row["data"], row["_metadata"])), 1 if is_addition else -1))
        if row["data"] in (b"stop", "stop"):
            raise StopRun

    def drive():
        while not deltas:
            time.sleep(0.02)
        for step in (steps or [lambda: (root / "c.txt").write_bytes(b"gamma added"),
                               lambda: (root / "a.txt").write_bytes(b"alpha rewritten, longer"),
                               lambda: os.remove(root / "b.txt")]) + [lambda: (root / "z.txt").write_bytes(b"stop")]:
            time.sleep(0.7)  # past the reader's 0.5 s poll
            step()

    pw.io.subscribe(t, on_change=on_change)
    changer = threading.Thread(target=drive, daemon=True)
    changer.start()
    with pytest.raises(StopRun):
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    changer.join()
    return deltas


def test_fs_streaming_add_rewrite_delete(tmp_path):
    """The JAX package's reader sees only the added file: a rewrite and a
    deletion emit nothing there.  The port's takes them back, as the
    reference's scanner does.  Both insert the same keys and rows for what
    they read; the port's final state is JAX's static read of the final
    directory."""
    got = {}
    for pw in PACKAGES:
        root = tmp_path / pw.__name__
        root.mkdir()
        (root / "a.txt").write_bytes(b"alpha")
        (root / "b.txt").write_bytes(b"beta")
        got[pw] = streaming_run(pw, root)
        pw.G.clear()
    jax, port = got[jpw], got[tpw]
    assert [(n, d) for _k, n, _r, d in jax] == [("a.txt", 1), ("b.txt", 1), ("c.txt", 1), ("z.txt", 1)]
    assert [(n, d) for _k, n, _r, d in port] == [("a.txt", 1), ("b.txt", 1), ("c.txt", 1), ("a.txt", -1),
                                                 ("a.txt", 1), ("b.txt", -1), ("z.txt", 1)]
    # the same keys and rows (paths aside: each package read its own directory)
    same = lambda ds: [(k, n, r[1][0]) for k, n, r, _d in ds]  # noqa: E731
    assert same(port[:3]) == same(jax[:3])
    assert port[3][:3] == port[0][:3] and port[5][:3] == port[1][:3]  # retractions of the rows inserted
    live = {}
    for key, _n, row, diff in port:
        if diff > 0:
            live[key] = row[1][0]
        else:
            del live[key]
    static = progs.capture(jpw, {"t": jpw.io.fs.read(str(tmp_path / tpw.__name__), format="binary", mode="static")})
    assert sorted(live.values()) == sorted(row[1][0] for _t, _k, _d, row in static["t"])


def test_fs_streaming_append_and_edit_lines(tmp_path):
    """A line format read in streaming mode: a file that grows by a line
    gives that line alone in both packages, with the same key.  An edit of
    an earlier line leaves the line count as it was, so the JAX package's
    reader emits nothing; the port's takes back the file's old lines and
    inserts its new ones."""
    got = {}
    for pw in PACKAGES:
        root = tmp_path / pw.__name__
        root.mkdir()
        (root / "a.txt").write_text("one\ntwo\n")

        def append(root=root):
            with open(root / "a.txt", "a") as f:
                f.write("three\n")

        got[pw] = streaming_run(pw, root, "plaintext",
                                [append, lambda root=root: (root / "a.txt").write_text("uno\ntwo\nthree\n")])
        pw.G.clear()
    jax, port = got[jpw], got[tpw]
    rows = lambda ds: [(k, n, r[1][0], d) for k, n, r, d in ds]  # noqa: E731
    assert [(n, d) for _k, n, _r, d in jax] == [("a.txt", 1)] * 3 + [("z.txt", 1)]
    assert rows(port[:3]) == rows(jax[:3]) and [r[2][1] for r in rows(port[:3])] == ["one", "two", "three"]
    assert [(n, d) for _k, n, _r, d in port[3:]] == [("a.txt", -1)] * 3 + [("a.txt", 1)] * 3 + [("z.txt", 1)]
    assert sorted(rows(port[3:6])) == sorted((k, n, r, -1) for k, n, r, _d in rows(port[:3]))
    assert sorted(r[2][1] for r in rows(port[6:9])) == ["three", "two", "uno"]

"""The port's temporal slice held to the JAX package's.

Each program of ``tests/torch_dataflow_programs.py::temporal_program``
(tumbling, sliding, session and ``intervals_over`` windows on int times,
with and without an instance, the sliding branches and the flatten path;
windows on ``DateTimeUtc`` and ``DateTimeNaive`` times; ``common_behavior``
with ``delay``, ``cutoff`` and ``keep_results=False`` and
``exactly_once_behavior``; the four modes of ``asof_join``,
``interval_join`` and ``window_join``, and ``asof_now_join``; streams with
late rows and retractions over five epochs) runs through both packages;
the change streams, keys, times and float bits included, are equal on the
columnar path and on the row path (``PATHWAY_COLUMNAR=0``, here
``vector_compiler.set_enabled(False)``), and the port's pure-Python core
(``PATHWAY_NATIVE=0``, in a subprocess; the sliding branches' salted
rekey included) gives the native core's (``chip_smoke.py``'s ``[temporal]``
program at a small size is ``tests/test_torch_temporal_embed.py``'s).
``pw.viz``'s snapshot fallback and ``plot``'s ``ImportError``, ``pw.demo``'s streams, ``utc_now``
and ``inactivity_detection`` are held to the JAX package's too.
"""

from __future__ import annotations

import datetime
import importlib
import sys

import pytest

import pathway_tpu as pj
import pathway_tpu_torch as pt
from tests import torch_dataflow_programs as P

PATHS = {True: "columnar", False: "row"}
PACKAGES = (pj, pt)


@pytest.fixture(autouse=True)
def clean_graphs():
    for pw in PACKAGES:
        pw.G.clear()
    yield
    for pw in PACKAGES:
        pw.G.clear()


@pytest.fixture(scope="module")
def python_core_run(tmp_path_factory):
    """The temporal suite of the port under ``PATHWAY_NATIVE=0``, started in
    a subprocess at the module's first test."""
    out = tmp_path_factory.mktemp("temporal_python_core") / "deltas.pkl"
    proc = P.spawn_python_core(out, "temporal")
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def streams(python_core_run) -> dict:
    return {pw.__name__: P.capture_suite_paths(pw, "temporal") for pw in PACKAGES}


@pytest.mark.parametrize("columnar", list(PATHS), ids=list(PATHS.values()))
@pytest.mark.parametrize("name", P.TEMPORAL_PROGRAMS)
def test_temporal_program_matches_jax(streams, name, columnar):
    want, got = streams["pathway_tpu"][columnar][name], streams["pathway_tpu_torch"][columnar][name]
    assert sorted(got) == sorted(want)
    for table, deltas in want.items():
        assert deltas, table  # every table of every program produced rows
        assert got[table] == deltas, table


@pytest.mark.parametrize("columnar", list(PATHS), ids=list(PATHS.values()))
@pytest.mark.parametrize("name", P.TEMPORAL_PROGRAMS)
def test_python_core_matches_native(streams, python_core_run, name, columnar):
    got = P.python_core_result(*python_core_run)
    assert got[columnar][name] == streams["pathway_tpu_torch"][columnar][name]


def test_programs_reach_late_rows_retractions_and_drops(streams):
    """The streams carry what the slice is for: the cutoff drops late rows
    that the plain windows keep, a forgetting behavior retracts closed
    windows, and both packages' exactly-once output revises a window that a
    late row reaches before the next window closes (the JAX package's
    buffer-then-freeze, which the port keeps)."""
    got = streams["pathway_tpu_torch"][True]["behaviors"]
    counts = {name: sum(d * row[1][2][1] for _t, _k, d, row in got[name]) for name in ("delay", "cutoff")}
    assert counts["cutoff"] < counts["delay"]
    assert any(d < 0 for _t, _k, d, _r in got["forget"])
    late = got["exactly_once_late"]
    assert [d for _t, _k, d, _r in late] == [1, -1, 1, 1, 1]
    assert late == streams["pathway_tpu"][True]["behaviors"]["exactly_once_late"]


DOCTESTED = ("stdlib.temporal._window", "stdlib.temporal._asof_join", "stdlib.temporal._interval_join", "demo")


@pytest.mark.parametrize("module", DOCTESTED)
def test_copied_docstring_examples_run(module):
    assert P.doctest_failures(pt, module) == 0


# ---------------------------------------------------------------------------
# pw.viz, pw.demo and the clock
# ---------------------------------------------------------------------------


def test_show_falls_back_to_a_snapshot(monkeypatch):
    """Without ``panel``/``bokeh``, ``show`` gives the subscriber-fed
    snapshot, whose frame after ``pw.run`` is the JAX package's."""
    monkeypatch.setitem(sys.modules, "panel", None)
    frames = []
    for pw in PACKAGES:
        t = P.temporal_program(pw, "tumbling")["plain"]
        snap, stream = t.show(), t.show(snapshot=False, include_id=False)
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        assert type(snap).__name__ == "TableSnapshot"
        assert "<table" in snap._repr_html_()
        frames.append((snap.to_pandas().to_dict("list"), stream.to_pandas().to_dict("list")))
        pw.G.clear()
    assert frames[0] == frames[1]
    assert len(frames[1][1]["diff"]) > len(frames[1][0]["n"])


def test_plot_raises_without_panel(monkeypatch):
    monkeypatch.setitem(sys.modules, "panel", None)
    messages = []
    for pw in PACKAGES:
        with pytest.raises(ImportError) as err:
            pw.debug.table_from_markdown("x | y\n1 | 2").plot(lambda source: None)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "panel" in messages[1]


def _demo_values(pw, name: str, path) -> list:
    class Row(pw.Schema):
        t: int
        v: float

    tables = {
        "range_stream": lambda: pw.demo.range_stream(nb_rows=6, offset=3, input_rate=5e3, autocommit_duration_ms=5),
        "replay_csv": lambda: pw.demo.replay_csv(str(path), schema=Row, input_rate=5e3),
        "replay_csv_with_time": lambda: pw.demo.replay_csv_with_time(str(path), schema=Row, time_column="t",
                                                                     unit="ms", speedup=1e3),
        "custom": lambda: pw.demo.generate_custom_stream({"t": lambda i: i * i, "v": lambda i: i / 4}, schema=Row,
                                                         nb_rows=5, autocommit_duration_ms=5, input_rate=5e3),
        "noisy": lambda: pw.demo.noisy_linear_stream(nb_rows=5, input_rate=5e3),
    }
    t = tables[name]()
    rows = []
    t._subscribe_raw(lambda key, row, time, diff: rows.append((P.canon(row), diff)))
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    pw.G.clear()
    return sorted(rows)


@pytest.mark.parametrize("name", ["range_stream", "replay_csv", "replay_csv_with_time", "custom", "noisy"])
def test_demo_streams_match_jax(tmp_path, name):
    """``pw.demo``'s streams give the JAX package's rows at a high rate (a
    stream's epochs follow its reader thread, so times are not compared)."""
    path = tmp_path / "rows.csv"
    path.write_text("t,v\n" + "".join(f"{3 * i},{i / 2}\n" for i in range(7)))
    want, got = (_demo_values(pw, name, path) for pw in PACKAGES)
    assert got == want and len(got) >= 5


def test_utc_now_streams_timestamps():
    from pathway_tpu_torch.stdlib.temporal import utc_now

    utc_now.cache_clear()  # the per-process cache would return a table of a cleared graph
    seen = []
    t = utc_now(refresh_rate=datetime.timedelta(milliseconds=50))
    pt.io.subscribe(t, on_change=lambda key, row, time, is_addition: seen.append(row["timestamp_utc"]))
    pt.run(monitoring_level=pt.MonitoringLevel.NONE, max_epochs=2)
    utc_now.cache_clear()
    assert seen and all(ts.tzinfo is not None for ts in seen)


def test_inactivity_detection_builds_as_in_jax():
    """The alert pattern wires ``utc_now``, ``asof_now_join`` and the
    groupbys into tables of the JAX package's columns (a live run needs
    a wall clock that never ends)."""
    columns = []
    for pw in PACKAGES:
        utils = importlib.import_module(pw.__name__ + ".stdlib.temporal.time_utils")
        utils.utc_now.cache_clear()
        events = pw.debug.table_from_markdown("v\n1").select(
            pw.this.v, at=pw.cast(pw.DateTimeUtc, datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)))
        for instance in (None, events.v):
            inactive, resumed = utils.inactivity_detection(events.at, datetime.timedelta(seconds=5), instance=instance)
            columns.append((inactive.column_names(), resumed.column_names()))
        utils.utc_now.cache_clear()
    assert columns[:2] == columns[2:]
    assert columns[2] == (["inactive_t"], ["resumed_t"])

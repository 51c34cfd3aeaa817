"""The port's epoch profiler and SLO evaluator against the JAX package's.

The profiler (``engine/profiler.py``): one program runs under
``PATHWAY_PROFILE=1`` in both packages, and their final snapshots name
the same operators with the same row counts and inputs (step seconds
differ, so they are left out); the output file and the top-N gauges come
out alike, and ``render_snapshot`` renders a snapshot to the same text.
The SLO evaluator (``engine/slo.py``): the same declarations fed the same
readings at the same instants (``tests/test_slo.py``'s synthetic clock)
give the same burn rates, budgets and violations in both packages.
"""

from __future__ import annotations

import json

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import metrics as jmetrics
from pathway_tpu.engine import profiler as jprofiler
from pathway_tpu.engine import slo as jslo
from pathway_tpu_torch.engine import metrics as tmetrics
from pathway_tpu_torch.engine import profiler as tprofiler
from pathway_tpu_torch.engine import slo as tslo


@pytest.fixture(autouse=True)
def _clean():
    tpw.G.clear()
    yield
    tpw.G.clear()
    jslo.reset_for_tests()
    tslo.reset_for_tests()


def profiled_run(pw, out_path) -> tuple:
    t = pw.debug.table_from_markdown(
        "k | v | __time__\n1 | 2 | 2\n1 | 3 | 2\n2 | 5 | 4\n3 | 7 | 4\n2 | 1 | 6")
    names = pw.debug.table_from_markdown("k | name\n1 | one\n2 | two\n3 | three")
    sums = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v))
    joined = sums.join(names, pw.left.k == pw.right.k).select(pw.right.name, pw.left.s)
    joined._subscribe_raw(lambda *a: None, name="sums")
    try:
        result = pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    finally:
        pw.G.clear()
    snap = result.profiler.snapshot
    ops = sorted((op["name"], op["rows_in"], op["rows_out"], tuple(op["inputs"]), op["path"])
                 for op in snap["operators"])
    gauges = sorted(k for k in result.profiler.metrics_snapshot())
    written = json.load(open(out_path))
    return (snap["epochs"], snap["operators_total"], ops, gauges, sorted(written),
            len(written["operators"]) == len(snap["operators"]))


def test_profiler_snapshots_name_the_same_operators_and_rows(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_PROFILE", "1")
    monkeypatch.setenv("PATHWAY_PROFILE_SAMPLE_EVERY", "1")
    got = {}
    for name, pw in (("jax", jpw), ("torch", tpw)):
        out = tmp_path / f"{name}.json"
        monkeypatch.setenv("PATHWAY_PROFILE_OUTPUT", str(out))
        got[name] = profiled_run(pw, out)
    assert got["torch"] == got["jax"]
    epochs, total, ops, gauges, keys, same_len = got["torch"]
    assert total == len(ops) >= 5 and same_len and "operators" in keys
    assert "profiler.epochs.sampled" in gauges
    assert any(name == "groupby" for name, *_ in ops)


SNAPSHOT = {
    "epochs": 12, "operators_total": 3, "total_step_seconds": 2.0,
    "operators": [
        {"id": 1, "name": "groupby", "seconds": 1.5, "share": 0.75, "rows_in": 10, "rows_out": 4, "inputs": [0],
         "path": "columnar"},
        {"id": 2, "name": "join", "seconds": 0.4, "share": 0.2, "rows_in": 4, "rows_out": 4, "inputs": [1, 0],
         "path": None},
        {"id": 0, "name": "input", "seconds": 0.1, "share": 0.05, "rows_in": 10, "rows_out": 10, "inputs": []},
    ],
    "bails": [{"op": "select", "reason": "udf", "count": 3}],
}


@pytest.mark.parametrize("top", [None, 1, 2])
def test_render_snapshot_is_the_same_text(top):
    assert tprofiler.render_snapshot(SNAPSHOT, top=top) == jprofiler.render_snapshot(SNAPSHOT, top=top)
    assert tprofiler.render_snapshot({}) == jprofiler.render_snapshot({})


def slo_readings(slo, metrics, decl: str, steps) -> list:
    """``steps``: (seconds, observations) evaluated in turn on a fresh
    registry; returns every evaluation's output and the violation count."""
    reg = metrics.MetricsRegistry(enabled=True)
    h = reg.histogram("serve.latency.ms", "latency", buckets=(50, 100, 250))
    ev = slo.SLOEvaluator([slo.parse_slo(decl)], registry=reg)
    outs = []
    for now, values in steps:
        for v in values:
            h.observe(v)
        outs.append(ev.evaluate(now=now))
    return outs, reg.scalar_metrics().get("slo.violations{slo=lat}"), [(s.name, s.metric, s.threshold, s.target, s.window_s) for s in ev.slos]


SCENARIOS = {
    "at-budget": ("lat: serve.latency.ms p95 < 100ms over 5m", [(1000.0, []), (1030.0, [10.0] * 19 + [500.0])]),
    "boundary-is-good": ("lat: serve.latency.ms p95 < 100ms over 5m", [(0.0, []), (30.0, [100.0])]),
    "exhausted": ("lat: serve.latency.ms p95 < 100ms over 5m", [(0.0, []), (30.0, [9999.0] * 10)]),
    "edge-recovery-edge": ("lat: serve.latency.ms p95 < 100ms over 5m",
                           [(1000.0, []), (1030.0, [9999.0] * 10), (1045.0, []), (1400.0, []),
                            (1430.0, [9999.0] * 10)]),
    "short-spike": ("lat: serve.latency.ms p99 < 100ms over 1h",
                    [(0.0, []), (600.0, [10.0] * 1000), (3000.0, [10.0] * 1000), (3030.0, [9999.0] * 5)]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_slo_verdicts_are_the_same_on_the_same_readings(scenario):
    decl, steps = SCENARIOS[scenario]
    got = slo_readings(tslo, tmetrics, decl, steps)
    assert got == slo_readings(jslo, jmetrics, decl, steps)
    outs, violations, _slos = got
    last = outs[-1]
    if scenario == "exhausted":
        assert last["slo.budget.remaining{slo=lat}"] == pytest.approx(-19.0)
    if scenario == "edge-recovery-edge":
        assert violations == 2.0
    if scenario in ("at-budget", "boundary-is-good", "short-spike"):
        assert violations is None


def test_declarations_parse_alike(monkeypatch):
    monkeypatch.setenv("PATHWAY_SLOS", "fresh: freshness.e2e.ms p95 < 5000ms over 1m; lat: serve.latency.ms < 2s over 1h")
    got = [[(s.name, s.metric, s.threshold, s.target, s.window_s) for s in m.parse_slos(m.default_declarations())]
           for m in (tslo, jslo)]
    assert got[0] == got[1] and ("fresh", "freshness.e2e.ms", 5000.0, 0.95, 60.0) in got[0]
    for bad in ("nonsense", "x: serve.latency.ms p95 < 100ms", "x: y p101 < 1 over 1m"):
        errors = []
        for m in (tslo, jslo):
            try:
                m.parse_slo(bad)
                errors.append(None)
            except ValueError as exc:
                errors.append(str(exc))
        assert errors[0] == errors[1] is not None

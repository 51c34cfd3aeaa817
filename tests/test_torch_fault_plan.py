"""The port's worker and connector fault kinds against the JAX package's.

``tests/test_fault_injection.py``'s plan cases for the kinds this slice
brings (``crash``, ``hang``, ``handoff_crash``, ``standby_lag``,
``promote_crash``, ``connector_read``, ``connector_stall``,
``load_spike``): the same plan and the same event sequence fire the same
specs in both packages, ``maybe_crash`` SIGKILLs a forked worker at its
epoch and leaves its flight-recorder dump, and the connector kinds run
through each package's reader supervision loop with the same rows out.
"""

from __future__ import annotations

import importlib
import json
import multiprocessing
import os
import signal
import time

import pytest

import pathway_tpu  # noqa: F401 - imported once here, inherited by every forked child
import pathway_tpu_torch  # noqa: F401
from pathway_tpu.engine import faults as jfaults
from pathway_tpu_torch.engine import faults as tfaults
from tests.torch_cluster_programs import PACKAGES

pytestmark = pytest.mark.chaos

WORKER_KINDS = ("crash", "hang", "handoff_crash", "standby_lag", "promote_crash")
CONNECTOR_KINDS = ("connector_read", "connector_stall", "load_spike")


@pytest.fixture(autouse=True)
def _clean_plans():
    for f in (jfaults, tfaults):
        f.clear_plan()
    yield
    for f in (jfaults, tfaults):
        f.clear_plan()


def test_kind_catalog_equals_jax():
    assert tfaults.KINDS == jfaults.KINDS
    assert set(WORKER_KINDS + CONNECTOR_KINDS) <= set(tfaults.KINDS)


EVENTS = [
    ("crash", {"worker": 1, "epoch": e}) for e in range(6)
] + [
    ("hang", {"worker": 0, "epoch": 2}), ("handoff_crash", {"worker": 1}),
    ("handoff_crash", {"worker": 0}), ("standby_lag", {"worker": 0}),
    ("standby_lag", {"worker": 1}), ("promote_crash", {"worker": 1}),
    ("promote_crash", {"worker": 0}),
] + [
    (kind, {"source": src}) for kind in CONNECTOR_KINDS for src in ("SubjectReader", "CsvReader") * 4
]

PLANS = {
    "worker": [
        {"kind": "crash", "worker": 1, "at_epoch": 3, "attempt": 0},
        {"kind": "hang", "worker": 0, "at_epoch": 2},
        {"kind": "handoff_crash", "worker": 0},
        {"kind": "standby_lag", "worker": 1, "delay_ms": 400},
        {"kind": "promote_crash", "worker": 0},
    ],
    "connector": [
        {"kind": "connector_read", "source": "Csv", "nth": 2},
        {"kind": "connector_stall", "source": "Subject", "from_nth": 2, "max_times": 2, "delay_ms": 5},
        {"kind": "load_spike", "prob": 0.5, "delay_ms": 100},
    ],
}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("attempt", ["0", "1"])
def test_same_plan_same_events_fire_the_same_specs(monkeypatch, plan, attempt):
    monkeypatch.setenv("PATHWAY_RESTART_ATTEMPT", attempt)
    fired = []
    for f in (jfaults, tfaults):
        p = f.FaultPlan(PLANS[plan], seed=5)
        fired.append([(s.describe(), s.delay_ms) if (s := p.check(k, **ctx)) else None for k, ctx in EVENTS])
        assert [line.split(" @ ")[0] for line in p.log] == [
            d for d, _ms in filter(None, fired[-1])
        ]
    assert fired[0] == fired[1]
    assert any(fired[1])


def test_standby_lag_sleeps_and_raises_nothing(monkeypatch):
    monkeypatch.setenv("PATHWAY_FAULT_PLAN", json.dumps(
        {"faults": [{"kind": "standby_lag", "worker": 2, "delay_ms": 30}]}
    ))
    t0 = time.monotonic()
    tfaults.maybe_standby_lag(standby=1)
    assert time.monotonic() - t0 < 0.025
    tfaults.maybe_standby_lag(standby=2)
    assert time.monotonic() - t0 >= 0.03


def _crash_child(pkg, root):
    os.environ["PATHWAY_FAULT_PLAN"] = json.dumps({"faults": [{"kind": "crash", "worker": 0, "at_epoch": 2}]})
    faults = importlib.import_module(f"{pkg}.engine.faults")
    box = importlib.import_module(f"{pkg}.engine.flight_recorder")
    faults.clear_plan()
    box.configure(root=root, worker=0)
    for epoch in range(5):
        faults.maybe_crash(worker=0, epoch=epoch)
        box.record("crash-test.epoch", index=epoch)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_crash_sigkills_at_its_epoch_after_dumping_the_flight_recorder(tmp_path, pkg):
    proc = multiprocessing.get_context("fork").Process(target=_crash_child, args=(pkg, str(tmp_path)))
    proc.start()
    proc.join(30)
    assert proc.exitcode == -signal.SIGKILL
    dumps = importlib.import_module(f"{pkg}.engine.flight_recorder").gather_dumps(str(tmp_path))
    [dump] = dumps[0]
    assert dump["reason"] == "injected crash (worker 0, epoch 2)"
    assert [e["index"] for e in dump["events"] if e["kind"] == "crash-test.epoch"] == [0, 1]


def _reader_rows(pkg: str, plan: list, reader_name: str, budget: int):
    """Rows a 5-row reader delivers under ``plan`` in ``pkg``."""
    pw = importlib.import_module(pkg)
    utils = importlib.import_module(f"{pkg}.io._utils")
    importlib.import_module(f"{pkg}.engine.faults").install_plan(
        importlib.import_module(f"{pkg}.engine.faults").FaultPlan(plan)
    )

    def run(self, emit):
        for i in range(5):
            emit({"k": i})
        emit(utils.COMMIT)

    reader = type(reader_name, (utils.Reader,), {"max_allowed_consecutive_errors": budget, "run": run})
    table = utils.make_input_table(pw.schema_from_types(k=int), reader, autocommit_duration_ms=50)
    rows = []
    pw.io.subscribe(table, on_change=lambda key, row, time, is_addition: rows.append((row["k"], is_addition)))
    try:
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    finally:
        pw.G.clear()
    return sorted(rows)


@pytest.mark.parametrize("case", ["read_within_budget", "stall", "load_spike"])
def test_connector_faults_deliver_the_same_rows(case):
    plan = {
        "read_within_budget": [{"kind": "connector_read", "nth": 3}],
        "stall": [{"kind": "connector_stall", "source": "Slow", "nth": 2, "delay_ms": 100}],
        "load_spike": [{"kind": "load_spike", "source": "Bursty", "nth": 2, "delay_ms": 150}],
    }[case]
    name = {"read_within_budget": "Steady", "stall": "Slow", "load_spike": "Bursty"}[case]
    got = []
    for pkg in PACKAGES:
        t0 = time.monotonic()
        got.append(_reader_rows(pkg, plan, name, budget=2))
        if case != "read_within_budget":
            assert time.monotonic() - t0 >= 0.1, pkg
    assert got[0] == got[1] == [(k, True) for k in range(5)]


def test_connector_read_past_budget_fails_like_jax():
    messages = []
    for pkg in PACKAGES:
        dataflow = importlib.import_module(f"{pkg}.engine.dataflow")
        with pytest.raises(dataflow.EngineError, match="consecutive errors") as err:
            _reader_rows(pkg, [{"kind": "connector_read", "prob": 1.0, "source": "Doomed"}], "Doomed", 1)
        messages.append(str(err.value))
    assert messages[0] == messages[1]

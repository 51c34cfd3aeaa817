"""The port's freshness tracker against the JAX package's.

Mirrors ``tests/test_freshness.py``: the same DAG of ``InputNode``s and
``OutputNode``s, the same ingest stamps and the same fake pollers go to
``pathway_tpu.engine.freshness.FreshnessTracker`` and to its copy in
``pathway_tpu_torch``, and the tests compare the watermarks, e2e
histograms, staleness, backlog gauges and snapshots both give.  The chaos
cases run in both packages: a ``connector_stall`` through ``pw.run`` and
a ``device_stall`` on each package's ``DeviceExecutor`` with a tracker
over a small dataflow.
"""

from __future__ import annotations

import queue
import threading
import time

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu import device as jdev
from pathway_tpu.engine import dataflow as jdf
from pathway_tpu.engine import faults as jfaults
from pathway_tpu.engine import freshness as jfresh
from pathway_tpu.engine import metrics as jmetrics
from pathway_tpu_torch import device as tdev
from pathway_tpu_torch.engine import dataflow as tdf
from pathway_tpu_torch.engine import faults as tfaults
from pathway_tpu_torch.engine import freshness as tfresh
from pathway_tpu_torch.engine import metrics as tmetrics

PACKAGES = {
    "jax": (jdf, jfresh, jmetrics),
    "torch": (tdf, tfresh, tmetrics),
}


@pytest.fixture(autouse=True)
def _clean():
    tpw.G.clear()
    jfaults.clear_plan()
    tfaults.clear_plan()
    yield
    tpw.G.clear()
    jfaults.clear_plan()
    tfaults.clear_plan()


def both(fn):
    """``{package: fn(df, freshness, metrics)}`` for both packages."""
    return {name: fn(*mods) for name, mods in PACKAGES.items()}


def test_watermark_is_the_min_over_the_dag_in_both_packages():
    t0 = time.monotonic()

    def run(df, fresh, metrics):
        scope = df.Scope()
        a, b = df.InputNode(scope), df.InputNode(scope)
        mid = df.Node(scope, [a, b])
        out = df.OutputNode(scope, mid)
        out.sink_name = "wm-parity-sink"
        tracker = fresh.FreshnessTracker(enabled=True)
        tracker.attach(scope, [])
        a.epoch_ingest_wallclock = t0 - 0.200
        b.epoch_ingest_wallclock = t0 - 0.050
        out._saw_data_this_epoch = True
        tracker.after_epoch(scope, now=t0)
        hist = metrics.get_registry().histogram(
            "freshness.e2e.ms", buckets=metrics.MS_BUCKETS, output="wm-parity-sink")
        _bounds, _counts, total, n = hist.snapshot()
        return (tracker._frontier, total, n, tracker.staleness(now=t0 + 5.0),
                tracker.worst_staleness(now=t0 + 5.0))

    got = both(run)
    assert got["torch"] == got["jax"]
    frontier, total, n, stale, worst = got["torch"]
    assert frontier[2] == t0 - 0.200 and n >= 1
    assert stale["wm-parity-sink"] == pytest.approx(5.2) and worst == stale["wm-parity-sink"]


def test_completed_outputs_stop_aging_and_labels_are_sanitized():
    t0 = time.monotonic()

    def run(df, fresh, metrics):
        scope = df.Scope()
        live, static = df.InputNode(scope), df.InputNode(scope)
        static_out = df.OutputNode(scope, static)
        static_out.sink_name = "static-sink"
        live_out = df.OutputNode(scope, live)
        live_out.sink_name = "orders,region={eu}"
        tracker = fresh.FreshnessTracker(enabled=True)
        for node in (live, static):
            node.epoch_ingest_wallclock = t0
        for node in (static_out, live_out):
            node._saw_data_this_epoch = True
        tracker.after_epoch(scope, now=t0)
        before = tracker.staleness(now=t0 + 1.0)
        static.finished = True
        after = tracker.staleness(now=t0 + 3600.0)
        snap = tracker.snapshot()
        keys = sorted(k for k in tracker.metrics_snapshot() if k.startswith("output."))
        return before, after, snap["outputs"]["static-sink"]["complete"], keys, \
            fresh.render_freshness({"epochs_tracked": 1, "outputs": {"s": {"complete": True,
                                                                          "delivered_ago_s": 1.0}}})

    got = both(run)
    assert got["torch"] == got["jax"]
    before, after, complete, keys, rendered = got["torch"]
    assert set(before) == {"static-sink", "orders_region__eu_"}
    assert set(after) == {"orders_region__eu_"} and complete is True
    assert keys == ["output.staleness.s{output=orders_region__eu_}"]
    assert "complete (last delivery 1.0 s ago)" in rendered


class _FakePoller:
    def __init__(self, df, scope, name="fakesrc", queued=3):
        self.name = name
        self.q = queue.Queue()
        for i in range(queued):
            self.q.put(i)
        self.input_node = df.InputNode(scope)
        self.finished = False
        self.last_row_mono = time.monotonic() - 1.5


def test_backlog_gauges_are_the_same_in_both_packages():
    def run(df, fresh, metrics):
        scope = df.Scope()
        poller = _FakePoller(df, scope, name="src=1,b")
        poller.input_node.insert(1, (1,), 2)
        poller.input_node.insert(2, (2,), 2)
        poller.input_node.insert(3, (3,), 4)
        tracker = fresh.FreshnessTracker(enabled=True)
        tracker.attach(scope, [poller])
        snap = tracker.metrics_snapshot()
        exact = {k: v for k, v in snap.items() if ".age." not in k and ".idle." not in k}
        poller.finished = True
        finished = sorted(tracker.metrics_snapshot())
        disabled = fresh.FreshnessTracker(enabled=False)
        disabled.after_epoch(scope)
        return sorted(snap), exact, snap["backlog.connector.idle.s{source=src_1_b}"] >= 1.5, finished, \
            disabled.metrics_snapshot()

    got = both(run)
    assert got["torch"] == got["jax"]
    keys, exact, idle, finished, disabled = got["torch"]
    assert exact == {"backlog.connector.queue{source=src_1_b}": 3.0,
                     "backlog.ingest.rows{source=src_1_b}": 3.0, "backlog.epochs.pending": 2.0}
    assert idle and "backlog.connector.idle.s{source=src_1_b}" not in finished
    assert disabled == {"backlog.epochs.pending": 0.0}


def test_mesh_staleness_gauge_takes_the_worst_worker_in_both_packages():
    def run(df, fresh, metrics):
        tracker = fresh.FreshnessTracker(enabled=True)
        tracker.record_mesh_staleness([0.5, None, 2.25])
        worst = metrics.get_registry().scalar_metrics()["freshness.mesh.staleness.s"]
        tracker.record_mesh_staleness([None, None])
        return worst, metrics.get_registry().scalar_metrics()["freshness.mesh.staleness.s"]

    got = both(run)
    assert got["torch"] == got["jax"] == (2.25, 0.0)


STALL_MS = 600.0


@pytest.mark.chaos
@pytest.mark.parametrize("package", ["jax", "torch"])
def test_connector_stall_drives_staleness_while_epochs_stay_flat(package):
    """``tests/test_freshness.py``'s acceptance pin in each package: an
    injected ``connector_stall`` ages ``output.staleness.s`` and the
    source's idle gauge while every epoch stays under 250 ms and the
    delivered updates' e2e p95 stays under half the stall."""
    pw, faults, metrics = (jpw, jfaults, jmetrics) if package == "jax" else (tpw, tfaults, tmetrics)

    class Src(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(10):
                self.next(k=i % 3, v=i)
                self.commit()
                time.sleep(0.02)

    plan = faults.FaultPlan([{"kind": "connector_stall", "source": "SubjectReader", "nth": 11,
                              "delay_ms": STALL_MS}], seed=3)
    faults.install_plan(plan)
    t = pw.io.python.read(Src(), schema=pw.schema_from_types(k=int, v=int), name="stallsrc")
    counts = t.groupby(t.k).reduce(k=t.k, n=pw.reducers.count())
    seen = []
    pw.io.subscribe(counts.select(k=pw.this.k, n2=pw.this.n * 2), on_change=lambda **kw: seen.append(kw),
                    name="stall-sink")
    reg = metrics.get_registry()
    samples, idle = [], []
    done = threading.Event()

    def sampler():
        while not done.is_set():
            for key, value in reg.collect().items():
                if key == "output.staleness.s{output=stall-sink}":
                    samples.append(value)
                elif key == "backlog.connector.idle.s{source=stallsrc}":
                    idle.append(value)
            time.sleep(0.02)

    epochs = reg.histogram("epoch.duration.ms", buckets=metrics.MS_BUCKETS)
    bounds, before, _, n0 = epochs.snapshot()
    thread = threading.Thread(target=sampler, daemon=True)
    thread.start()
    try:
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    finally:
        done.set()
        thread.join(timeout=5)
        faults.clear_plan()
    _, after, _, n1 = epochs.snapshot()
    assert [s for s in plan.log if "connector_stall" in s] and seen
    assert max(samples) >= STALL_MS / 1000.0 * 0.5 and max(idle) >= STALL_MS / 1000.0 * 0.5
    slow_from = next(i for i, b in enumerate(bounds) if b > 250.0)
    assert n1 > n0 and sum(a - b for a, b in zip(after[slow_from:], before[slow_from:])) == 0
    assert reg.scalar_metrics()["freshness.e2e.ms.p95{output=stall-sink}"] < STALL_MS / 2.0


@pytest.mark.chaos
@pytest.mark.parametrize("package", ["jax", "torch"])
def test_device_stall_moves_backlog_and_staleness_while_epochs_stay_flat(package):
    """``tests/test_device_executor.py``'s ``device_stall`` pin with its
    dataflow half, in each package: while the dispatch is stalled,
    ``backlog.device.age.s`` and the output's staleness grow and every
    epoch of the small dataflow closes fast; once the future lands the
    output is fresh again."""
    if package == "jax":
        df, fresh, faults, metrics = jdf, jfresh, jfaults, jmetrics
        ex = jdev.DeviceExecutor(collector_name=None)
    else:
        df, fresh, faults, metrics = tdf, tfresh, tfaults, tmetrics
        ex = tdev.DeviceExecutor("cpu", collector_name=None)
    faults.install_plan(faults.FaultPlan([{"kind": "device_stall", "source": "chaos-embed", "nth": 1,
                                           "delay_ms": STALL_MS}], seed=11))
    try:
        scope = df.Scope()
        inp = df.InputNode(scope)
        out = df.OutputNode(scope, inp)
        out.sink_name = "device-sink"
        tracker = fresh.FreshnessTracker(enabled=True)
        tracker.attach(scope, [])
        inp.epoch_ingest_wallclock = time.monotonic()
        out._saw_data_this_epoch = True
        tracker.after_epoch(scope, now=time.monotonic())
        fut = ex.submit(lambda: "embedded", name="chaos-embed")
        hist = metrics.get_registry().histogram("epoch.duration.ms", buckets=metrics.MS_BUCKETS,
                                                chaos=f"device-stall-{package}")
        ages, stale = [], []
        while not fut.done():
            t0 = time.monotonic()
            out._saw_data_this_epoch = False
            tracker.after_epoch(scope, now=time.monotonic())
            hist.observe((time.monotonic() - t0) * 1000.0)
            ages.append(ex.metrics_snapshot()["backlog.device.age.s"])
            stale.append(tracker.staleness(now=time.monotonic()).get("device-sink", 0.0))
            time.sleep(0.01)
        assert fut.result(timeout=5.0) == "embedded"
        inp.epoch_ingest_wallclock = time.monotonic()
        out._saw_data_this_epoch = True
        tracker.after_epoch(scope, now=time.monotonic())
    finally:
        faults.clear_plan()
        ex.close()
    assert max(ages) >= STALL_MS / 1000.0 * 0.5 and max(stale) >= STALL_MS / 1000.0 * 0.5
    bounds, counts, _total, n = hist.snapshot()
    assert n == len(ages)
    assert sum(c for b, c in zip(list(bounds) + [float("inf")], counts) if b > 250.0) == 0
    assert tracker.staleness(now=time.monotonic())["device-sink"] < 1.0


def test_flight_recorder_dump_carries_the_freshness_section(tmp_path):
    from pathway_tpu.engine import flight_recorder as jfr
    from pathway_tpu_torch.engine import flight_recorder as tfr

    sections = {}
    for name, fr in (("jax", jfr), ("torch", tfr)):
        df, fresh, _metrics = PACKAGES[name]
        scope = df.Scope()
        inp = df.InputNode(scope)
        out = df.OutputNode(scope, inp)
        out.sink_name = "bb-sink"
        tracker = fresh.FreshnessTracker(enabled=True)
        tracker.attach(scope, [])
        inp.epoch_ingest_wallclock = time.monotonic() - 0.5
        out._saw_data_this_epoch = True
        tracker.after_epoch(scope)
        rec = fr.FlightRecorder()
        rec.configure(root=str(tmp_path / name), worker=0, run_id="r-fresh")
        rec.set_freshness_supplier(tracker.crash_snapshot)
        rec.record("epoch", time=2)
        import json

        sections[name] = json.loads(open(rec.dump("stalled")).read())["freshness"]
    for section in sections.values():
        assert section["epochs_tracked"] == 1 and section["outputs"]["bb-sink"]["staleness_s"] >= 0.5
    assert sorted(sections["torch"]) == sorted(sections["jax"])

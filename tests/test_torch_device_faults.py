"""Device-path fault tolerance: the port against the JAX package, scenario
by scenario.

Mirrors ``tests/test_device_faults.py:163-880``.  Each test runs one
scenario through ``pathway_tpu`` (its executor, its fault plan, its
registry and flight recorder) and through ``pathway_tpu_torch`` (the
same, copied), with the same fault-plan JSON, and compares what both
expose: outputs (f32, 1e-6), ``device.*`` counter deltas by name, breaker
state sequences, bucket caps, quarantine records and the flight-recorder
event kinds.

The port's host fallback is explicit (``host_fallback=`` at
registration); the scenarios pass it the same elementwise callable the
reference falls back to by default.  The last test pins the port-only
case: with no fallback, a tripped breaker quarantines.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
import types

import numpy as np
import pytest

import pathway_tpu.device as jdev
import pathway_tpu_torch.device as tdev
from pathway_tpu.device import resilience as jres
from pathway_tpu.engine import faults as jfaults
from pathway_tpu.engine import flight_recorder as jbox
from pathway_tpu.engine import metrics as jmetrics
from pathway_tpu.utils.batching import AsyncMicroBatcher as JBatcher
from pathway_tpu_torch.device import resilience as tres
from pathway_tpu_torch.engine import faults as tfaults
from pathway_tpu_torch.engine import flight_recorder as tbox
from pathway_tpu_torch.engine import metrics as tmetrics
from pathway_tpu_torch.utils.batching import AsyncMicroBatcher as TBatcher

TOL = 1e-6
RNG = np.random.default_rng(13)

# the reference's event kinds; the port also records ``device.fallback``
REF_KINDS = {
    "device.failure", "device.oom.ratchet", "device.breaker.open", "device.breaker.close",
    "device.quarantine", "device.dispatch.restart", "fault.device_hang",
}


_MADE: list = []  # every executor a test makes; closed after the test


def _made(ex):
    _MADE.append(ex)
    return ex


def _side(port: bool):
    if port:
        return types.SimpleNamespace(
            port=True, dev=tdev, res=tres, faults=tfaults, box=tbox, reg=tmetrics.get_registry,
            Batcher=TBatcher, make=lambda **kw: _made(tdev.DeviceExecutor("cpu", collector_name=None, **kw)),
        )
    return types.SimpleNamespace(
        port=False, dev=jdev, res=jres, faults=jfaults, box=jbox, reg=jmetrics.get_registry,
        Batcher=JBatcher, make=lambda **kw: _made(jdev.DeviceExecutor(collector_name=None, **kw)),
    )


SIDES = (_side(False), _side(True))


def _lin(x):
    return x * 2.0 + 1.0


def _register(side, ex, name, fn, *, max_bucket=8, min_bucket=1, fallback=None, **kw):
    """Register ``fn``; the port gets an explicit host fallback (``fallback``,
    else ``fn`` itself), the reference its default (``fn`` un-jitted) or
    ``fallback``."""
    policy = side.dev.BucketPolicy(min_bucket=min_bucket, max_bucket=max_bucket)
    if side.port:
        kw["host_fallback"] = fallback or fn
    elif fallback is not None:
        kw["host_fallback"] = fallback
    ex.register(name, fn, policy=policy, **kw)
    return ex


def _plan(side, faults_json):
    side.faults.install_plan(side.faults.FaultPlan.from_json(json.dumps(faults_json)))


class _Watch:
    """Counter deltas and new flight-recorder event kinds of one side."""

    NAMES = (
        "device.retry.attempts", "device.oom.splits", "device.breaker.trips", "device.fallback.batches",
        "device.fallback.rows", "device.quarantine.batches", "device.dispatch.restarts",
        "device.dispatch.batches", "device.dispatch.rows", "device.pad.rows",
    )

    def __init__(self, side, callable_name=None):
        self.side = side
        self.name = callable_name
        self.before = {n: side.reg().counter(n).value for n in self.NAMES}
        events = side.box.get_recorder().events()
        self.seq = events[-1]["seq"] if events else 0

    def deltas(self) -> dict:
        return {n: self.side.reg().counter(n).value - v for n, v in self.before.items()}

    def kinds(self) -> list:
        out = []
        for e in self.side.box.get_recorder().events():
            if e["seq"] <= self.seq or e["kind"] not in REF_KINDS:
                continue
            if self.name is None or self.name in (e.get("callable"), e.get("job")):
                out.append(e["kind"])
        return out


def _events(side, kind):
    return [e for e in side.box.get_recorder().events() if e["kind"] == kind]


@pytest.fixture(autouse=True)
def _clean_plans_and_executors():
    for side in SIDES:
        side.faults.clear_plan()
    yield
    for side in SIDES:
        side.faults.clear_plan()
    while _MADE:
        _MADE.pop().close(timeout_s=2.0)


def _agree(results: list, keys=None):
    """Both sides' result dicts agree (outputs at 1e-6, the rest exactly)."""
    ref, got = results
    for key in keys or ref:
        a, b = ref[key], got[key]
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=key)
        else:
            assert b == a, (key, a, b)


# --- retry and OOM degradation -----------------------------------------------


def test_transient_failure_retries_and_recovers(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_RETRY_BACKOFF_MS", "1")
    rows = RNG.normal(size=(5, 4)).astype(np.float32)
    results = []
    for side in SIDES:
        ex = _register(side, side.make(), "lin", _lin)
        _plan(side, {"seed": 13, "faults": [{"kind": "device_error", "source": "lin", "nth": 1}]})
        w = _Watch(side, "lin")
        out = ex.run_batch("lin", (rows,))
        st = ex.resilience_stats("lin")
        results.append(dict(out=out, deltas=w.deltas(), kinds=w.kinds(), failures=st["failures"],
                            state=st["breaker"]["state"], fallback=st["fallback_batches"]))
    _agree(results)
    got = results[1]
    np.testing.assert_array_equal(got["out"], rows * 2.0 + 1.0)
    assert got["deltas"]["device.retry.attempts"] == 1
    assert got["failures"] == {"transient": 1} and got["state"] == "closed" and got["fallback"] == 0
    assert got["kinds"] == ["device.failure"]


def test_oom_mid_stream_ratchets_bucket_cap_and_completes():
    rows = RNG.normal(size=(16, 4)).astype(np.float32)
    results = []
    for side in SIDES:
        ex = _register(side, side.make(), "lin", _lin, max_bucket=16)
        _plan(side, {"seed": 13, "faults": [{"kind": "device_oom", "source": "lin", "nth": 1}]})
        w = _Watch(side, "lin")
        out = ex.run_batch("lin", (rows,))
        st = ex.resilience_stats("lin")
        before = ex.stats("lin")["dispatches"]
        out2 = ex.run_batch("lin", (rows,))
        results.append(dict(out=out, out2=out2, deltas=w.deltas(), kinds=w.kinds(), cap=st["bucket_cap"],
                            splits=st["oom_splits"], more=ex.stats("lin")["dispatches"] - before,
                            gauge=ex.metrics_snapshot()["device.bucket.cap{callable=lin}"]))
    _agree(results)
    got = results[1]
    np.testing.assert_array_equal(got["out2"], rows * 2.0 + 1.0)
    assert got["cap"] == 8 and got["splits"] == 1 and got["more"] == 2 and got["gauge"] == 8.0
    assert got["deltas"]["device.oom.splits"] == 1
    assert got["kinds"] == ["device.failure", "device.oom.ratchet"]


def test_oom_at_smallest_bucket_falls_back_to_host():
    rows = RNG.normal(size=(3, 4)).astype(np.float32)
    results = []
    for side in SIDES:
        ex = _register(side, side.make(), "lin", _lin, min_bucket=4, max_bucket=4)
        _plan(side, {"seed": 13, "faults": [
            {"kind": "device_oom", "source": "lin", "from_nth": 1, "max_times": 99}]})
        w = _Watch(side, "lin")
        out = ex.run_batch("lin", (rows,))
        st = ex.resilience_stats("lin")
        results.append(dict(out=out, cap=st["bucket_cap"], fb=st["fallback_batches"], deltas=w.deltas(),
                            kinds=w.kinds()))
    _agree(results)
    assert results[1]["cap"] is None and results[1]["fb"] == 1
    assert results[1]["deltas"]["device.fallback.rows"] == 3


# --- circuit breaker and host fallback ----------------------------------------


def test_breaker_trips_to_host_fallback_and_recovers_half_open(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("PATHWAY_DEVICE_BREAKER_COOLDOWN_S", "0.2")
    monkeypatch.setenv("PATHWAY_DEVICE_RETRIES", "0")
    rows = RNG.normal(size=(5, 4)).astype(np.float32)
    results = []
    for side in SIDES:
        ex = _register(side, side.make(), "lin", _lin)
        expected = ex.run_batch("lin", (rows,))
        keys = ex.stats("lin")["keys"]
        _plan(side, {"seed": 13, "faults": [
            {"kind": "device_error", "source": "lin", "from_nth": 1, "max_times": 2}]})
        w = _Watch(side, "lin")
        states, outs = [], []
        for _ in range(3):
            outs.append(ex.run_batch("lin", (rows,)))
            states.append(ex.resilience_stats("lin")["breaker"]["state"])
        mid = w.deltas()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            outs.append(ex.run_batch("lin", (rows,)))
            if ex.resilience_stats("lin")["breaker"]["state"] == "closed":
                break
            time.sleep(0.05)
        states.append(ex.resilience_stats("lin")["breaker"]["state"])
        fb = side.reg().counter("device.fallback.batches").value
        outs.append(ex.run_batch("lin", (rows,)))
        for out in outs:
            np.testing.assert_array_equal(out, expected)
        results.append(dict(expected=expected, states=states, keys=ex.stats("lin")["keys"] - keys,
                            fb_mid=mid["device.fallback.batches"], trips=mid["device.breaker.trips"],
                            fb_after=side.reg().counter("device.fallback.batches").value - fb,
                            kinds=[k for k in w.kinds() if k != "device.failure"],
                            snapshot_trips=ex.resilience_stats("lin")["breaker"]["trips"]))
    _agree(results)
    got = results[1]
    assert got["states"] == ["closed", "open", "open", "closed"]
    assert got["fb_mid"] == 3 and got["trips"] == 1 and got["fb_after"] == 0 and got["keys"] == 0
    assert got["kinds"] == ["device.breaker.open", "device.breaker.close"]


def test_compile_failure_is_not_retried_and_serves_from_fallback(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_RETRIES", "3")
    monkeypatch.setenv("PATHWAY_DEVICE_RETRY_BACKOFF_MS", "1")
    rows = RNG.normal(size=(3, 4)).astype(np.float32)
    results = []
    for side in SIDES:
        ex = _register(side, side.make(), "lin", _lin)
        _plan(side, {"seed": 13, "faults": [{"kind": "device_compile_fail", "source": "lin", "nth": 1}]})
        w = _Watch(side, "lin")
        out = ex.run_batch("lin", (rows,))
        st = ex.resilience_stats("lin")
        results.append(dict(out=out, retries=w.deltas()["device.retry.attempts"], failures=st["failures"],
                            fb=st["fallback_batches"]))
    _agree(results)
    assert results[1]["retries"] == 0 and results[1]["failures"] == {"compile": 1} and results[1]["fb"] == 1


def _poison_fallback(x):
    raise ValueError("poisoned row")


def test_poisoned_batch_quarantines_with_typed_error(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_RETRIES", "0")
    rows = RNG.normal(size=(3, 4)).astype(np.float32)
    results = []
    for side in SIDES:
        ex = _register(side, side.make(), "poison", lambda x: x * 2.0, fallback=_poison_fallback)
        _plan(side, {"seed": 13, "faults": [
            {"kind": "device_error", "source": "poison", "from_nth": 1, "max_times": 99}]})
        w = _Watch(side, "poison")
        with pytest.raises(side.res.DeviceQuarantinedError, match="quarantined"):
            ex.run_batch("poison", (rows,))
        records = [{k: v for k, v in r.items() if k != "ts"} for r in ex.quarantine_records()]
        side.faults.clear_plan()
        _register(side, ex, "ok", lambda x: x + 1.0)
        ok = ex.run_batch("ok", (rows,))
        results.append(dict(records=records, q=w.deltas()["device.quarantine.batches"], kinds=w.kinds(), ok=ok))
    _agree(results)
    got = results[1]
    assert got["q"] == 1 and len(got["records"]) == 1
    rec = got["records"][0]
    assert rec["callable"] == "poison" and rec["rows"] == 3
    assert "poisoned row" in rec["fallback_error"] and "injected transient" in rec["device_error"]
    assert got["kinds"] == ["device.failure", "device.quarantine"]


def test_host_bug_during_probe_releases_the_slot(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_BREAKER_COOLDOWN_S", "0.3")
    monkeypatch.setenv("PATHWAY_DEVICE_RETRY_BACKOFF_MS", "1")
    rows = RNG.normal(size=(3, 4)).astype(np.float32)
    results = []
    for side in SIDES:
        ex = _register(side, side.make(), "lin", _lin)
        _plan(side, {"seed": 13, "faults": [
            {"kind": "device_error", "source": "lin", "from_nth": 1, "max_times": 15}]})
        for _ in range(6):
            ex.run_batch("lin", (rows,))
        entry = ex._callables["lin"]
        opened = entry.breaker.state_name()
        side.faults.clear_plan()
        time.sleep(0.35)  # the cooldown elapses: the next admit is the probe
        real_fixed = ex._dispatch_fixed
        fired = []

        def bomb(*args, real_fixed=real_fixed, fired=fired, **kwargs):
            if not fired:
                fired.append(True)
                raise ValueError("host bug, not a device failure")
            return real_fixed(*args, **kwargs)

        monkeypatch.setattr(ex, "_dispatch_fixed", bomb)
        with pytest.raises(ValueError):
            ex.run_batch("lin", (rows,))
        out = ex.run_batch("lin", (rows,))
        results.append(dict(opened=opened, out=out, state=entry.breaker.state_name(),
                            trips=entry.breaker.snapshot()["trips"]))
    _agree(results)
    assert results[1]["opened"] == "open" and results[1]["state"] == "closed" and results[1]["trips"] == 1


def test_warmup_dispatches_take_the_typed_failure_path(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_RETRY_BACKOFF_MS", "1")
    for side in SIDES:
        ex = _register(side, side.make(), "lin", _lin)
        _plan(side, {"seed": 13, "faults": [{"kind": "device_error", "source": "lin", "nth": 1}]})
        warmed = ex.warmup("lin", row_shapes=((4,),), dtypes=(np.float32,))
        assert warmed == len(ex._callables["lin"].policy.buckets())
        _plan(side, {"seed": 13, "faults": [{"kind": "device_compile_fail", "source": "lin", "nth": 1}]})
        ex2 = _register(side, side.make(), "lin", _lin)
        with pytest.raises(side.res.DeviceCompileError):
            ex2.warmup("lin", row_shapes=((4,),), dtypes=(np.float32,))


def test_host_bug_propagates_raw_and_skips_the_breaker():
    def buggy(x):
        raise ValueError("bad row shape logic")

    for side in SIDES:
        ex = _register(side, side.make(), "buggy", buggy)
        with pytest.raises(ValueError, match="bad row shape logic"):
            ex.run_batch("buggy", (np.ones((2, 4), np.float32),))
        st = ex.resilience_stats("buggy")
        assert st["failures"] == {} and st["breaker"]["consecutive_failures"] == 0 and st["fallback_batches"] == 0


def test_resilience_kill_switch_reverts_to_raw_dispatch(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_RESILIENCE", "0")
    for side in SIDES:
        ex = _register(side, side.make(), "lin", _lin)
        assert ex.resilience_stats("lin")["breaker"] is None
        _plan(side, {"seed": 13, "faults": [{"kind": "device_error", "source": "lin", "nth": 1}]})
        with pytest.raises(side.res.InjectedDeviceError):
            ex.run_batch("lin", (np.ones((2, 4), np.float32),))


# --- dispatch-hang escalation ------------------------------------------------


def test_device_hang_restarts_dispatch_thread(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_DISPATCH_DEADLINE_S", "0.3")
    results = []
    for side in SIDES:
        ex = side.make()
        _plan(side, {"seed": 13, "faults": [
            {"kind": "device_hang", "source": "wedge", "nth": 1, "delay_ms": 10000}]})
        w = _Watch(side)
        try:
            fut = ex.submit(lambda: "never", name="wedge")
            ages = []
            t0 = time.monotonic()
            while not fut.done():
                ages.append(ex.metrics_snapshot()["backlog.device.age.s"])
                time.sleep(0.02)
                assert time.monotonic() - t0 < 10.0
            with pytest.raises(side.res.DeviceDispatchHangError, match="hard deadline"):
                fut.result(timeout=1.0)
            alive = ex.submit(lambda: "alive", name="after").result(timeout=5.0)
            deadline = time.monotonic() + 5.0
            while ex.metrics_snapshot()["backlog.device.queue"] and time.monotonic() < deadline:
                time.sleep(0.01)
            snap = ex.metrics_snapshot()
            results.append(dict(alive=alive, restarts=w.deltas()["device.dispatch.restarts"],
                                kinds=sorted(w.kinds()), aged=max(ages) >= 0.15,
                                idle=(snap["backlog.device.bytes"], snap["backlog.device.queue"]),
                                hang=side.reg().counter("device.failures", kind="hang").value > 0))
        finally:
            ex.close(timeout_s=2.0)
    _agree(results)
    got = results[1]
    assert got["alive"] == "alive" and got["restarts"] == 1 and got["aged"] and got["idle"] == (0.0, 0.0)
    assert got["kinds"] == ["device.dispatch.restart", "fault.device_hang"]


# --- shutdown semantics ------------------------------------------------------


def test_submit_after_close_raises_typed_error():
    for side in SIDES:
        ex = side.make()
        ex.close()
        with pytest.raises(side.res.ExecutorClosedError, match="closed"):
            ex.submit(lambda: 1, name="late")
        ex2 = _register(side, side.make(), "lin", _lin)
        ex2.close()
        with pytest.raises(side.res.ExecutorClosedError, match="closed"):
            ex2.run_batch("lin", (np.ones((2, 4), np.float32),))


def test_close_fails_inflight_waiters_instead_of_stranding_them():
    for side in SIDES:
        ex = side.make()
        gate = threading.Event()
        started = threading.Event()

        def wedge(gate=gate, started=started):
            started.set()
            while not gate.wait(timeout=0.05):
                pass
            return "late"

        running = ex.submit(wedge, name="running", nbytes=100)
        queued = ex.submit(lambda: "queued", name="queued", nbytes=50)
        assert started.wait(timeout=5.0)
        ex.close(timeout_s=0.2)
        with pytest.raises(side.res.ExecutorClosedError):
            running.result(timeout=1.0)
        with pytest.raises(side.res.ExecutorClosedError):
            queued.result(timeout=1.0)
        gate.set()
        with pytest.raises(side.res.ExecutorClosedError):
            running.result(timeout=1.0)
        assert ex.metrics_snapshot()["backlog.device.bytes"] == 0.0


def test_close_drains_queued_jobs_when_it_can():
    for side in SIDES:
        ex = side.make()
        fut = ex.submit(lambda: "done", name="quick")
        ex.close(timeout_s=5.0)
        assert fut.result(timeout=1.0) == "done"


def test_close_drains_queued_run_batch_jobs():
    rows = np.ones((3, 4), np.float32)
    outs = []
    for side in SIDES:
        ex = _register(side, side.make(), "lin", _lin)
        gate = threading.Event()
        started = threading.Event()

        def wedge(gate=gate, started=started):
            started.set()
            gate.wait(timeout=10.0)
            return "gate"

        ex.submit(wedge, name="gate")
        fut = ex.submit(lambda ex=ex: ex.run_batch("lin", (rows,)), name="batchy")
        assert started.wait(timeout=5.0)
        closer = threading.Thread(target=lambda ex=ex: ex.close(timeout_s=5.0))
        closer.start()
        deadline = time.monotonic() + 5.0
        while not ex._closed and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ex._closed
        gate.set()
        closer.join(timeout=10.0)
        assert not closer.is_alive()
        outs.append(np.asarray(fut.result(timeout=1.0)))
    np.testing.assert_allclose(outs[1], outs[0], rtol=TOL)
    np.testing.assert_allclose(outs[1], rows * 2.0 + 1.0)


def test_close_during_retry_backoff_delivers_closed_error_not_fallback(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_RETRY_BACKOFF_MS", "60000")
    rows = np.ones((2, 4), np.float32)
    for side in SIDES:
        ex = _register(side, side.make(), "lin", _lin)
        _plan(side, {"seed": 13, "faults": [{"kind": "device_error", "source": "lin", "from_nth": 1}]})
        caught: list = []
        started = threading.Event()

        def run(ex=ex, caught=caught, started=started):
            started.set()
            try:
                ex.run_batch("lin", (rows,))
            except BaseException as exc:  # noqa: BLE001 - asserted below
                caught.append(exc)

        t = threading.Thread(target=run)
        t.start()
        assert started.wait(timeout=5.0)
        time.sleep(0.3)
        ex.close(timeout_s=2.0)
        t.join(timeout=10.0)
        assert not t.is_alive()
        assert len(caught) == 1 and isinstance(caught[0], side.res.ExecutorClosedError)
        entry = ex._callables["lin"]
        assert entry.fallback_batches == 0
        assert entry.breaker.snapshot()["trips"] == 0
        assert entry.breaker.snapshot()["consecutive_failures"] == 0


def test_budget_blocked_submit_fails_on_close_not_resurrects_thread():
    for side in SIDES:
        ex = side.make(max_inflight_requests=1)
        gate = threading.Event()
        started = threading.Event()

        def wedge(gate=gate, started=started):
            started.set()
            gate.wait(timeout=10.0)
            return "gate"

        ex.submit(wedge, name="gate")
        assert started.wait(timeout=5.0)
        caught: list = []
        ran: list = []
        waiting = threading.Event()

        def blocked_submit(ex=ex, caught=caught, ran=ran, waiting=waiting):
            waiting.set()
            try:
                ex.submit(lambda: ran.append("late"), name="late")
            except BaseException as exc:  # noqa: BLE001 - asserted below
                caught.append(exc)

        t = threading.Thread(target=blocked_submit)
        t.start()
        assert waiting.wait(timeout=5.0)
        time.sleep(0.2)
        ex.close(timeout_s=0.2)
        t.join(timeout=10.0)
        gate.set()
        assert not t.is_alive()
        assert len(caught) == 1 and isinstance(caught[0], side.res.ExecutorClosedError)
        deadline = time.monotonic() + 5.0
        while ex._thread is not None and ex._thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert ex._thread is None or not ex._thread.is_alive()
        assert ran == []


# --- the micro-batcher front end ---------------------------------------------


def _fan_out(side, monkeypatch):
    ex = _register(side, side.make(), "enc", lambda x: x * 2.0, fallback=lambda x: _poison(x))
    _plan(side, {"seed": 13, "faults": [
        {"kind": "device_error", "source": "enc", "from_nth": 1, "max_times": 99}]})
    calls = []

    def process(items):
        calls.append(len(items))
        batch = np.stack([np.asarray(i, np.float32) for i in items])
        return list(ex.run_batch("enc", (batch,)))

    batcher = side.Batcher(process, max_batch_size=64, flush_delay=0.01, executor=ex)
    real_flush = batcher.flush

    def gated_flush():
        with batcher._lock:
            n = len(batcher._pending)
        if n < 10:
            return
        real_flush()

    batcher.flush = gated_flush
    gate = threading.Event()
    results: dict = {}
    try:
        ex.submit(lambda: gate.wait(timeout=5.0), name="gate")
        barrier = threading.Barrier(2, timeout=5.0)

        def run_loop(tag):
            async def main():
                barrier.wait()
                return await asyncio.gather(
                    *(batcher.submit(np.full(4, i, np.float32)) for i in range(5)), return_exceptions=True
                )

            results[tag] = asyncio.run(main())

        threads = [threading.Thread(target=run_loop, args=(tag,)) for tag in ("a", "b")]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with batcher._lock:
                if not batcher._pending and len(batcher._flushers) == 0:
                    break
            time.sleep(0.01)
        gate.set()
        for t in threads:
            t.join(timeout=10.0)
            assert not t.is_alive()
    finally:
        gate.set()
        ex.close()
    with batcher._lock:
        stranded = len(batcher._pending)
    return calls, results, stranded


def _poison(x):
    raise ValueError("poisoned")


def test_batcher_mid_coalesce_failure_fails_every_cross_loop_waiter_once(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_RETRIES", "0")
    for side in SIDES:
        calls, results, stranded = _fan_out(side, monkeypatch)
        assert calls == [10] and stranded == 0
        for tag in ("a", "b"):
            assert len(results[tag]) == 5
            for exc in results[tag]:
                assert isinstance(exc, side.res.DeviceQuarantinedError), exc


def test_batcher_submit_failure_after_close_fails_waiters_not_hangs():
    for side in SIDES:
        ex = side.make()
        batcher = side.Batcher(lambda items: items, max_batch_size=4, flush_delay=0.001, executor=ex)
        ex.close()

        async def main():
            return await asyncio.gather(batcher.submit(1), batcher.submit(2), return_exceptions=True)

        out = asyncio.run(main())
        assert all(isinstance(e, side.res.ExecutorClosedError) for e in out), out


# --- surfacing: snapshots and render -----------------------------------------


def test_device_snapshot_and_render_carry_resilience_state(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("PATHWAY_DEVICE_RETRIES", "0")
    snaps = []
    for side in SIDES:
        ex = _register(side, side.make(), "enc", lambda x: x * 2.0, fallback=_poison)
        _plan(side, {"seed": 13, "faults": [
            {"kind": "device_error", "source": "enc", "from_nth": 1, "max_times": 99}]})
        with pytest.raises(side.res.DeviceQuarantinedError):
            ex.run_batch("enc", (np.ones((2, 4), np.float32),))
        snap = ex.device_snapshot()
        json.dumps(snap)
        rendered = side.dev.render_device_snapshot(snap)
        assert "breaker open" in rendered
        assert "quarantine: 1 poisoned batch(es)" in rendered
        snaps.append(snap)
    ref, got = snaps
    # the port's snapshot has the reference's fields (and names its device)
    assert set(ref) <= set(got) and got["device"] == "cpu"
    assert set(ref["resilience"]) == set(got["resilience"])
    assert got["resilience"]["enabled"] is True
    rref, rgot = ref["resilience"]["callables"]["enc"], got["resilience"]["callables"]["enc"]
    assert rgot == rref
    assert len(got["resilience"]["quarantine"]) == 1
    assert set(ref["padding"]) == set(got["padding"]) and got["padding"] == ref["padding"]
    assert set(ref["cost"]) == set(got["cost"])
    assert set(ref["queue"]) == set(got["queue"])


def test_without_a_host_fallback_a_tripped_breaker_quarantines(monkeypatch):
    """Port-only: the fallback is explicit.  With none, a batch the device
    fails is quarantined, and once the breaker is open, batches are
    quarantined without touching the device; no batch counts as a
    fallback batch.  After the cooldown the probe recovers."""
    monkeypatch.setenv("PATHWAY_DEVICE_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("PATHWAY_DEVICE_BREAKER_COOLDOWN_S", "0.2")
    monkeypatch.setenv("PATHWAY_DEVICE_RETRIES", "0")
    ex = _made(tdev.DeviceExecutor("cpu", collector_name=None))
    ex.register("bare", _lin, policy=tdev.BucketPolicy(max_bucket=8))
    rows = RNG.normal(size=(3, 4)).astype(np.float32)
    tfaults.install_plan(tfaults.FaultPlan(
        [{"kind": "device_error", "source": "bare", "from_nth": 1, "max_times": 2}], seed=13))
    w = _Watch(SIDES[1], "bare")
    errors = []
    for _ in range(3):
        with pytest.raises(tres.DeviceQuarantinedError) as raised:
            ex.run_batch("bare", (rows,))
        errors.append(str(raised.value))
    st = ex.resilience_stats("bare")
    assert st["breaker"]["state"] == "open" and st["fallback_batches"] == 0
    assert "device failed" in errors[0] and "device not attempted (breaker open)" in errors[2]
    records = ex.quarantine_records()
    assert len(records) == 3
    assert all("no host fallback registered" in r["fallback_error"] for r in records)
    assert records[2]["device_error"] == "(device not attempted: breaker open)"
    deltas = w.deltas()
    assert deltas["device.quarantine.batches"] == 3 and deltas["device.fallback.batches"] == 0
    assert deltas["device.breaker.trips"] == 1
    time.sleep(0.25)
    np.testing.assert_allclose(ex.run_batch("bare", (rows,)), rows * 2.0 + 1.0, rtol=TOL)
    assert ex.resilience_stats("bare")["breaker"]["state"] == "closed"

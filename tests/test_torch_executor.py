"""The port's DeviceExecutor against the JAX package's, scenario by scenario.

Mirrors ``tests/test_device_executor.py:132-345`` and ``:549-591``: the
same batches go through ``pathway_tpu.device.DeviceExecutor`` (jitted JAX
callables) and ``pathway_tpu_torch.device.DeviceExecutor`` (the PyTorch
counterparts on the CPU), and the tests compare what both expose:
outputs (f32, 1e-6), the key ledger, padding gauges, the occupancy
histogram, ``backlog.device.*`` and the counters of the submit path.

Two differences are by design and pinned as such: the port's
``dispatches`` leave ``warmup`` out, and its ``warmup`` returns how many
buckets it ran.
"""

from __future__ import annotations

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu import device as jdev
from pathway_tpu.engine import faults as jfaults
from pathway_tpu.engine import metrics as jmetrics
from pathway_tpu.ops import topk as jtopk
from pathway_tpu_torch import device as tdev
from pathway_tpu_torch.engine import faults as tfaults
from pathway_tpu_torch.engine import metrics as tmetrics
from pathway_tpu_torch.ops import topk as ttopk

TOL = 1e-6


@pytest.fixture(autouse=True)
def _clean_plans():
    jfaults.clear_plan()
    tfaults.clear_plan()
    yield
    jfaults.clear_plan()
    tfaults.clear_plan()


@pytest.fixture
def pair():
    """A JAX executor and a port executor, closed after the test."""
    made = []

    def make(**kw):
        j = jdev.DeviceExecutor(collector_name=None, **kw)
        t = tdev.DeviceExecutor("cpu", collector_name=None, **kw)
        made.extend((j, t))
        return j, t

    yield make
    for ex in made:
        ex.close(timeout_s=2.0)


def _rowwise(j, t, max_bucket=8):
    policy = dict(policy=jdev.BucketPolicy(max_bucket=max_bucket))
    j.register("rowsum", lambda x: jnp.sum(x * x, axis=1), **policy)
    t.register("rowsum", lambda x: torch.sum(x * x, dim=1), policy=tdev.BucketPolicy(max_bucket=max_bucket))


def _both(j, t, name, arrays, **kw):
    a = j.run_batch(name, arrays, **kw)
    b = t.run_batch(name, arrays, **kw)
    return a, b


def _close(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


# --- fixed-shape dispatch and the key ledger ---------------------------------


def test_padded_rows_do_not_change_unpadded_outputs(pair):
    j, t = pair()
    _rowwise(j, t)
    rows = np.random.default_rng(7).normal(size=(4, 16)).astype(np.float32)
    full = _both(j, t, "rowsum", (rows,))
    padded = _both(j, t, "rowsum", (rows[:3],))
    _close(*full)
    _close(*padded)
    np.testing.assert_array_equal(full[1][:3], padded[1])
    assert t.stats("rowsum") == j.stats("rowsum")


def test_oversized_batch_splits_and_reassembles_in_order(pair):
    j, t = pair()
    _rowwise(j, t, max_bucket=8)
    rows = np.arange(19 * 2, dtype=np.float32).reshape(19, 2)
    a, b = _both(j, t, "rowsum", (rows,))
    _close(a, b)
    np.testing.assert_allclose(b, (rows * rows).sum(axis=1), rtol=TOL)
    assert t.stats("rowsum") == j.stats("rowsum") == {"dispatches": 3, "cold": 2, "warmed": 0, "keys": 2}


def test_tuple_outputs_unpad_per_leaf(pair):
    j, t = pair()
    j.register("pair", lambda x: (x * 2.0, jnp.sum(x, axis=1)), policy=jdev.BucketPolicy(max_bucket=8))
    t.register("pair", lambda x: (x * 2.0, torch.sum(x, dim=1)), policy=tdev.BucketPolicy(max_bucket=8))
    rows = np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)
    a, b = _both(j, t, "pair", (rows,))
    _close(a, b)
    assert b[0].shape == (3, 4) and b[1].shape == (3,)


def test_warmup_pays_every_bucket_and_steady_state_is_never_cold(pair):
    j, t = pair()
    _rowwise(j, t, max_bucket=16)
    n = len(tdev.BucketPolicy(max_bucket=16).buckets())
    assert j.warmup("rowsum", row_shapes=((4,),), dtypes=(np.float32,)) == n
    assert t.warmup("rowsum", row_shapes=((4,),), dtypes=(np.float32,)) == n
    rng = np.random.default_rng(3)
    for size in (1, 3, 7, 13, 16, 2, 11):
        _close(*_both(j, t, "rowsum", (rng.normal(size=(size, 4)).astype(np.float32),)))
    js, ts = j.stats("rowsum"), t.stats("rowsum")
    assert {k: ts[k] for k in ("cold", "warmed", "keys")} == {k: js[k] for k in ("cold", "warmed", "keys")}
    assert ts["cold"] == 0 and ts["warmed"] == ts["keys"] == n
    # by design the port's dispatches leave warmup out
    assert ts["dispatches"] == 7 and js["dispatches"] == 7 + n
    # a second warmup runs every bucket again and pays no new key
    assert t.warmup("rowsum", row_shapes=((4,),), dtypes=(np.float32,)) == n
    assert t.stats("rowsum")["keys"] == n


def test_static_args_extend_the_cache_key(pair):
    j, t = pair()
    j.register("topk", lambda x, *, k: jnp.sort(x, axis=1)[:, -k:], static_argnames=("k",),
               policy=jdev.BucketPolicy(max_bucket=8))
    t.register("topk", lambda x, *, k: torch.sort(x, dim=1).values[:, -k:], policy=tdev.BucketPolicy(max_bucket=8))
    rows = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    for k in (2, 3, 2):
        _close(*_both(j, t, "topk", (rows,), static={"k": k}))
    assert t.stats("topk")["keys"] == j.stats("topk")["keys"] == 2


def test_operands_extend_the_cache_key_by_shape_not_identity(pair):
    """Weights passed as an operand: new weights of the same shape reuse
    the key (and its counted cost), a new shape is a new key."""
    _, t = pair()
    t.register("affine", lambda w, x: x @ w, policy=tdev.BucketPolicy(max_bucket=8))
    x = np.ones((3, 4), np.float32)
    for w in (torch.ones(4, 2), torch.full((4, 2), 2.0), torch.ones(4, 5)):
        out = t.run_batch("affine", (x,), operands=(w,))
        np.testing.assert_allclose(out, x @ w.numpy(), rtol=TOL)
    assert t.stats("affine")["keys"] == 2


def _occupancy(reg, **kw):
    hist = reg.histogram("device.bucket.occupancy", buckets=jmetrics.OCCUPANCY_BUCKETS)
    return hist.snapshot()[1]


def _hist_delta(before, after):
    return [b - a for a, b in zip(before, after)]


def test_padding_waste_pin_batch_of_one(pair):
    j, t = pair()
    j.register("one", lambda x: jnp.sum(x, axis=1), policy=jdev.BucketPolicy(min_bucket=8, max_bucket=8))
    t.register("one", lambda x: torch.sum(x, dim=1), policy=tdev.BucketPolicy(min_bucket=8, max_bucket=8))
    jr, tr = jmetrics.get_registry(), tmetrics.get_registry()
    jo, to = _occupancy(jr), _occupancy(tr)
    _close(*_both(j, t, "one", (np.ones((1, 4), np.float32),)))
    js, ts = j.metrics_snapshot(), t.metrics_snapshot()
    for key in ("device.padding.waste.rows", "device.padding.waste.fraction"):
        assert ts[key] == js[key]
    assert ts["device.padding.waste.rows"] == 7.0
    assert ts["device.padding.waste.fraction"] == pytest.approx(7.0 / 8.0)
    assert _hist_delta(to, _occupancy(tr)) == _hist_delta(jo, _occupancy(jr))


def test_padding_waste_pin_oversize_split(pair):
    j, t = pair()
    _rowwise(j, t, max_bucket=8)
    jr, tr = jmetrics.get_registry(), tmetrics.get_registry()
    jo, to = _occupancy(jr), _occupancy(tr)
    _close(*_both(j, t, "rowsum", (np.ones((19, 4), np.float32),)))
    js, ts = j.metrics_snapshot(), t.metrics_snapshot()
    assert ts["device.padding.waste.rows"] == js["device.padding.waste.rows"] == 1.0
    assert ts["device.padding.waste.fraction"] == pytest.approx(js["device.padding.waste.fraction"])
    assert ts["device.padding.waste.fraction"] == pytest.approx(1.0 / 20.0)
    assert _hist_delta(to, _occupancy(tr)) == _hist_delta(jo, _occupancy(jr))
    assert tr.histogram("device.bucket.occupancy", buckets=tmetrics.OCCUPANCY_BUCKETS).quantile(0.99) is not None
    assert ts["device.batch.rows{rows=19}"] == js["device.batch.rows{rows=19}"] == 1.0


def test_rerun_registration_resets_the_ledger(pair):
    j, t = pair()
    _rowwise(j, t)
    _both(j, t, "rowsum", (np.ones((2, 4), np.float32),))
    j.register("rowsum", lambda x: jnp.sum(x, axis=1), policy=jdev.BucketPolicy(max_bucket=8))
    t.register("rowsum", lambda x: torch.sum(x, dim=1), policy=tdev.BucketPolicy(max_bucket=8))
    assert t.stats("rowsum") == j.stats("rowsum") == {"dispatches": 0, "cold": 0, "warmed": 0, "keys": 0}


# --- async dispatch: futures, budget, backlog --------------------------------


def test_submit_returns_future_and_runs_off_thread(pair):
    for ex in pair():
        caller = threading.current_thread().name
        fut = ex.submit(lambda: threading.current_thread().name, name="probe")
        assert fut.result(timeout=5.0) not in (caller, None)
        assert fut.done()


def test_submit_runs_jobs_in_inference_mode_on_its_thread(pair):
    _, t = pair()
    assert t.submit(torch.is_inference_mode_enabled, name="mode").result(timeout=5.0) is True


def test_submit_propagates_job_exceptions(pair):
    def boom():
        raise RuntimeError("device fell over")

    for ex in pair():
        with pytest.raises(RuntimeError, match="device fell over"):
            ex.submit(boom, name="boom").result(timeout=5.0)


def _backpressure(ex, reg) -> float:
    release = threading.Event()
    started = threading.Event()

    def slow():
        started.set()
        while not release.wait(timeout=0.05):
            pass
        return "slow"

    before = reg.scalar_metrics().get("device.backpressure.s", 0.0)
    try:
        first = ex.submit(slow, name="slow")
        assert started.wait(timeout=5.0)
        with pytest.raises(TimeoutError):
            ex.submit(lambda: "second", name="second", timeout_s=0.3)
        release.set()
        assert first.result(timeout=5.0) == "slow"
        assert ex.submit(lambda: "second", name="second", timeout_s=5.0).result(timeout=5.0) == "second"
    finally:
        release.set()
    return reg.scalar_metrics().get("device.backpressure.s", 0.0) - before


def test_inflight_budget_backpressures_and_counts_the_stall(pair):
    j, t = pair(max_inflight_requests=1, max_inflight_mb=1024)
    stalls = (_backpressure(j, jmetrics.get_registry()), _backpressure(t, tmetrics.get_registry()))
    for stall in stalls:
        assert stall >= 0.25  # the timed-out submit waited 0.3 s and was counted


def _backlog(ex) -> tuple[dict, dict]:
    release = threading.Event()
    started = threading.Event()

    def slow():
        started.set()
        while not release.wait(timeout=0.05):
            pass

    try:
        ex.submit(slow, name="slow", nbytes=1000)
        ex.submit(lambda: None, name="queued", nbytes=500)
        assert started.wait(timeout=5.0)
        busy = ex.metrics_snapshot()
        release.set()
        deadline = time.monotonic() + 5.0
        while ex.metrics_snapshot()["backlog.device.queue"] and time.monotonic() < deadline:
            time.sleep(0.01)
        return busy, ex.metrics_snapshot()
    finally:
        release.set()


def test_backlog_device_gauges_track_queue_and_age(pair):
    j, t = pair()
    for busy, idle in (_backlog(j), _backlog(t)):
        assert busy["backlog.device.queue"] == 2.0
        assert busy["backlog.device.bytes"] == 1500.0
        assert busy["backlog.device.age.s"] >= 0.0
        assert idle["backlog.device.queue"] == 0.0
        assert idle["backlog.device.bytes"] == 0.0
        assert idle["backlog.device.age.s"] == 0.0


def test_submit_from_dispatch_thread_is_refused(pair):
    for ex in pair():
        with pytest.raises(RuntimeError, match="dispatch thread"):
            ex.submit(lambda ex=ex: ex.submit(lambda: None, name="inner"), name="outer").result(timeout=5.0)


STALL_MS = 400.0


def _stalled(ex, faults, plan_cls) -> tuple[float, float]:
    faults.install_plan(plan_cls(
        [{"kind": "device_stall", "source": "chaos-embed", "nth": 1, "delay_ms": STALL_MS}], seed=11))
    t0 = time.monotonic()
    fut = ex.submit(lambda: "embedded", name="chaos-embed")
    ages = []
    while not fut.done():
        ages.append(ex.metrics_snapshot()["backlog.device.age.s"])
        time.sleep(0.01)
        assert time.monotonic() - t0 < 10.0
    assert fut.result(timeout=5.0) == "embedded"
    staleness = time.monotonic() - t0  # age of the result when it landed
    faults.clear_plan()
    return max(ages), staleness


def test_device_stall_moves_backlog_age_and_staleness(pair):
    """The port's half of the reference's stall pin (the epoch half needs
    the dataflow): the stalled job ages the backlog and the answer arrives
    late, in both packages alike."""
    j, t = pair()
    for ex, faults in ((j, jfaults), (t, tfaults)):
        age, staleness = _stalled(ex, faults, faults.FaultPlan)
        assert age >= STALL_MS / 1000.0 * 0.5, age
        assert staleness >= STALL_MS / 1000.0 * 0.9, staleness
        assert ex.metrics_snapshot()["backlog.device.age.s"] == 0.0


# --- the stock paths route through the default executor ----------------------


def test_default_executor_is_shared_and_collector_registered():
    ex = tdev.get_default_executor("cpu")
    assert ex is tdev.get_default_executor(torch.device("cpu"))
    assert ex.device == torch.device("cpu")
    assert "backlog.device.queue" in tmetrics.get_registry().collect()
    assert jdev.get_default_executor() is jdev.get_default_executor()
    assert "backlog.device.queue" in jmetrics.get_registry().collect()
    snap = tdev.default_executor_snapshot()
    assert "cpu" in snap and snap["cpu"]["device"] == "cpu"


def test_default_executor_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.get_default_executor()


def test_indexing_topk_routes_through_the_default_executor():
    matrix = np.random.default_rng(0).normal(size=(512, 16)).astype(np.float32)
    cache = ttopk.DeviceIndexCache(device="cpu")
    ex = tdev.get_default_executor("cpu")
    assert cache.executor is ex
    name = "indexing:masked_topk"
    idx, scores = ttopk.topk_search_cached(matrix, matrix[:3], 5, "cos", cache=cache, version=1)
    jidx, jscores = jtopk.topk_search_cached(matrix, matrix[:3], 5, "cos", cache=jtopk.DeviceIndexCache(), version=1)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(scores, jscores, atol=1e-5)
    assert idx.shape == (3, 5) and ex.registered(name)
    before = ex.stats(name)["keys"]
    ttopk.topk_search_cached(matrix, matrix[3:6], 5, "cos", cache=cache, version=1)
    assert ex.stats(name)["keys"] == before
    assert idx[0][0] == 0
    # a second index on the device shares the one registration
    assert ttopk.DeviceIndexCache(device="cpu").executor is ex


def test_search_many_batches_an_epochs_queries_into_one_dispatch():
    from pathway_tpu.stdlib.indexing.nearest_neighbors import BruteForceKnnIndex as JIndex
    from pathway_tpu.stdlib.indexing.nearest_neighbors import DistanceMetric as JMetric
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnIndex, DistanceMetric

    index = BruteForceKnnIndex(DistanceMetric.COS, device="cpu")
    jindex = JIndex(JMetric.COS)
    vecs = np.random.default_rng(1).normal(size=(400, 8)).astype(np.float32)
    for i in range(400):
        index.add(i, vecs[i])
        jindex.add(i, vecs[i])
    ex = tdev.get_default_executor("cpu")
    requests = [(vecs[i], 3, None) for i in (0, 7, 42, 99)]
    before = ex.dispatches("indexing:masked_topk") if ex.registered("indexing:masked_topk") else 0
    batched = index.search_many(requests)
    assert ex.dispatches("indexing:masked_topk") == before + 1
    single = [index.search(vecs[i], 3) for i in (0, 7, 42, 99)]
    assert [r[0][0] for r in batched] == [0, 7, 42, 99]
    # one dispatch, the same answers: the same keys, and the scores to
    # f32 rounding (a 4-row and a 1-row product sum in another order)
    for got, one in zip(batched, single):
        assert [k for k, _ in got] == [k for k, _ in one]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in one], rtol=0, atol=TOL)
    for got, ref in zip(batched, jindex.search_many(requests)):
        assert [k for k, _ in got] == [k for k, _ in ref]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], atol=1e-5)

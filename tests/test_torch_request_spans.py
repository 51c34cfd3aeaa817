"""Request-trace spans of the port's batcher and executor against the JAX
package's.

Mirrors ``tests/test_request_tracing.py:242-419``: a request's trace
(``engine/tracing.py``) is ambient where it is submitted; the coalescing
``AsyncMicroBatcher`` records a ``serve.batch`` span in each waiter's own
trace, and the ``DeviceExecutor`` a ``device.job`` span for the batch job
and a ``device.dispatch`` span for each fixed-shape chunk, with its cache,
retry and fallback attributes.  The same scenario runs in both packages
and the tests compare span names, parentage and attributes.
"""

from __future__ import annotations

import asyncio
import threading
import time

import numpy as np
import pytest

from pathway_tpu import device as jdev
from pathway_tpu.device import executor as jexecutor
from pathway_tpu.engine import faults as jfaults
from pathway_tpu.engine import tracing as jtracing
from pathway_tpu.utils import batching as jbatching
from pathway_tpu_torch import device as tdev
from pathway_tpu_torch.device import executor as texecutor
from pathway_tpu_torch.engine import faults as tfaults
from pathway_tpu_torch.engine import tracing as ttracing
from pathway_tpu_torch.utils import batching as tbatching

PACKAGES = {
    "jax": dict(dev=jdev, executor=jexecutor, faults=jfaults, tracing=jtracing, batching=jbatching,
                make=lambda: jdev.DeviceExecutor(collector_name=None),
                lin=lambda x: x * 2.0 + 1.0),
    "torch": dict(dev=tdev, executor=texecutor, faults=tfaults, tracing=ttracing, batching=tbatching,
                  make=lambda: tdev.DeviceExecutor("cpu", collector_name=None),
                  lin=lambda x: x * 2.0 + 1.0),
}


@pytest.fixture(autouse=True)
def _clean():
    for p in PACKAGES.values():
        p["tracing"].reset_for_tests()
        p["faults"].clear_plan()
    yield
    for p in PACKAGES.values():
        p["tracing"].reset_for_tests()
        p["faults"].clear_plan()


def shape(trace) -> list:
    """``(name, parent)`` of every span, the parent named by its span's
    name (``serve.request`` for the request's root span, which lands when
    the trace finishes), in the order recorded."""
    names = {trace.root_span_id: "serve.request"}
    names.update({s["span_id"]: s["name"] for s in trace.spans})
    return [(s["name"], names.get(s["parent_span_id"], s["parent_span_id"])) for s in trace.spans]


def request_through_batcher_and_executor(p) -> list:
    """One request: its trace ambient at ``submit``, the batcher's job on
    the executor's dispatch thread running ``run_batch`` inline."""
    ex = p["make"]()
    ex.register("lin", p["lin"], policy=p["dev"].BucketPolicy(max_bucket=8))

    def process(items):
        out = ex.run_batch("lin", (np.stack(items),))
        return list(np.asarray(out))

    batcher = p["batching"].AsyncMicroBatcher(process, max_batch_size=8, executor=ex, name="embedder")
    trace = p["tracing"].RequestTrace("/v1/embed")

    async def one():
        with p["tracing"].trace_scope(trace):
            return await batcher.submit(np.ones(4, np.float32))

    try:
        out = asyncio.run(one())
    finally:
        ex.close()
    trace.finish(status=200)
    np.testing.assert_allclose(out, np.full(4, 3.0))
    return [(name, parent, _attrs(s)) for (name, parent), s in zip(shape(trace), trace.spans)]


def _attrs(span) -> dict:
    keep = ("batcher", "batch_size", "job", "callable", "bucket", "rows", "cache", "retries", "fallback", "status")
    return {k: v for k, v in span["attributes"].items() if k in keep}


def test_a_request_through_the_batcher_and_the_executor_records_the_same_spans():
    got = {name: request_through_batcher_and_executor(p) for name, p in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    # every stage's span is a child of the request's root span
    assert [(n, parent) for n, parent, _a in got["torch"]] == [
        ("serve.batch", "serve.request"), ("device.dispatch", "serve.request"),
        ("device.job", "serve.request"), ("serve.request", ""),
    ]
    assert got["torch"][1][2] == {"callable": "lin", "bucket": 1, "rows": 1, "cache": "cold"}


def coalesce_across_loops(p) -> tuple:
    """Two threads, each its own loop and trace, coalesce into one batch
    run on its own thread (``run_in_thread``)."""
    gate = threading.Event()
    seen_in_batch = []

    class GatedBatcher(p["batching"].AsyncMicroBatcher):
        def flush(self):
            if gate.is_set():
                super().flush()

    def process(items):
        seen_in_batch.append(p["executor"]._current_traces())
        return [x * 10 for x in items]

    batcher = GatedBatcher(process, max_batch_size=8, flush_delay=0.005, run_in_thread=True)
    traces = [p["tracing"].RequestTrace("/a"), p["tracing"].RequestTrace("/b")]
    results = {}

    def worker(i):
        async def one():
            with p["tracing"].trace_scope(traces[i]):
                return await batcher.submit(i + 1)

        results[i] = asyncio.run(one())

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        with batcher._lock:
            if len(batcher._pending) == 2:
                break
        time.sleep(0.001)
    gate.set()
    for th in threads:
        th.join(timeout=10)
    batch_spans = [[_attrs(s) for s in t.spans if s["name"] == "serve.batch"] for t in traces]
    return (results, len(seen_in_batch), set(seen_in_batch[0]) == set(traces), batch_spans,
            [shape(t) for t in traces])


def test_coalesced_waiters_from_two_loops_each_get_their_own_span():
    got = {name: coalesce_across_loops(p) for name, p in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    results, batches, same_traces, batch_spans, _shapes = got["torch"]
    assert results == {0: 10, 1: 20} and batches == 1 and same_traces
    assert batch_spans == [[{"batcher": "process", "batch_size": 2}]] * 2


def dispatch_attributes(p, plan) -> list:
    ex = p["make"]()
    ex.register("lin", p["lin"], policy=p["dev"].BucketPolicy(max_bucket=8), host_fallback=p["lin"])
    rows = np.ones((2, 4), np.float32)
    trace = p["tracing"].RequestTrace("/q")
    try:
        with p["tracing"].trace_scope(trace):
            ex.run_batch("lin", (rows,))
            if plan is not None:
                p["faults"].install_plan(p["faults"].FaultPlan(plan, seed=13))
            out = ex.run_batch("lin", (rows,))
    finally:
        ex.close()
        p["faults"].clear_plan()
    np.testing.assert_allclose(np.asarray(out), rows * 2.0 + 1.0)
    return [_attrs(s) for s in trace.spans if s["name"] == "device.dispatch"]


@pytest.mark.parametrize("case", ["warm", "retried", "fallback"])
def test_device_dispatch_spans_carry_cache_retries_and_fallback(case, monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_RETRY_BACKOFF_MS", "1")
    plan = {"warm": None,
            "retried": [{"kind": "device_error", "source": "lin", "nth": 1}],
            "fallback": [{"kind": "device_error", "source": "lin", "from_nth": 1}]}[case]
    got = {name: dispatch_attributes(p, plan) for name, p in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    first, second = got["torch"]
    assert first == {"callable": "lin", "bucket": 2, "rows": 2, "cache": "cold"}
    if case == "warm":
        assert second == {"callable": "lin", "bucket": 2, "rows": 2, "cache": "warm"}
    elif case == "retried":
        assert second["retries"] == 1 and "fallback" not in second
    else:
        assert second["fallback"] is True and second["retries"] >= 1


def test_a_direct_submit_carries_the_ambient_trace_across_the_thread_hop():
    got = {}
    for name, p in PACKAGES.items():
        ex = p["make"]()
        trace = p["tracing"].RequestTrace("/q")
        try:
            with p["tracing"].trace_scope(trace):
                fut = ex.submit(lambda: 7, name="hostjob")
            assert fut.result(timeout=30) == 7
        finally:
            ex.close()
        got[name] = [(n, parent, _attrs(s)) for (n, parent), s in zip(shape(trace), trace.spans)]
    assert got["torch"] == got["jax"] == [("device.job", "serve.request", {"job": "hostjob"})]

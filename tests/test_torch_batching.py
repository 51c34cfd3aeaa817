"""The port's AsyncMicroBatcher against the JAX package's.

Mirrors ``tests/test_device_executor.py:347-466``: coalescing across
recreated event loops, no stranded state, a result-count mismatch failing
every waiter, and the deadline shed at submit and at dispatch (with the
``serve.deadline.exceeded`` counters), each scenario run through both
``pathway_tpu.utils.batching`` and ``pathway_tpu_torch.utils.batching``.
"""

from __future__ import annotations

import asyncio
import threading
import time
import types

import numpy as np
import pytest

import pathway_tpu.device as jdev
import pathway_tpu_torch.device as tdev
from pathway_tpu.engine import metrics as jmetrics
from pathway_tpu.engine import serving as jserving
from pathway_tpu.utils.batching import AsyncMicroBatcher as JBatcher
from pathway_tpu_torch.engine import metrics as tmetrics
from pathway_tpu_torch.engine import serving as tserving
from pathway_tpu_torch.utils.batching import AsyncMicroBatcher as TBatcher

SIDES = (
    types.SimpleNamespace(port=False, Batcher=JBatcher, serving=jserving, reg=jmetrics.get_registry,
                          make=lambda: jdev.DeviceExecutor(collector_name=None)),
    types.SimpleNamespace(port=True, Batcher=TBatcher, serving=tserving, reg=tmetrics.get_registry,
                          make=lambda: tdev.DeviceExecutor("cpu", collector_name=None)),
)


@pytest.fixture
def executors():
    made = []

    def make(side):
        ex = side.make()
        made.append(ex)
        return ex

    yield make
    for ex in made:
        ex.close(timeout_s=2.0)


def _coalesce(side, ex):
    batch_sizes: list[int] = []
    gate = threading.Event()

    def process(items):
        batch_sizes.append(len(items))
        return [i * 10 for i in items]

    batcher = side.Batcher(process, max_batch_size=64, flush_delay=0.01, executor=ex)
    real_flush = batcher.flush

    def gated_flush():
        # hold the window until both loops' items sit in the one pending list
        with batcher._lock:
            n = len(batcher._pending)
        if n < 20:
            return
        real_flush()

    batcher.flush = gated_flush
    results: dict = {}
    try:
        ex.submit(lambda: gate.wait(timeout=5.0), name="gate")
        barrier = threading.Barrier(2, timeout=5.0)

        def run_loop(tag, base):
            async def main():
                barrier.wait()
                return await asyncio.gather(*(batcher.submit(base + i) for i in range(10)))

            results[tag] = asyncio.run(main())

        threads = [threading.Thread(target=run_loop, args=("a", 0)), threading.Thread(target=run_loop, args=("b", 100))]
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
    with batcher._lock:
        stranded = len(batcher._pending)
    return results, batch_sizes, stranded


def test_batcher_coalesces_across_event_loop_recreation(executors):
    outs = []
    for side in SIDES:
        results, sizes, stranded = _coalesce(side, executors(side))
        assert results["a"] == [i * 10 for i in range(10)]
        assert results["b"] == [(100 + i) * 10 for i in range(10)]
        assert max(sizes) == 20, sizes
        assert stranded == 0
        outs.append((results, sizes))
    assert outs[1] == outs[0]


def test_batcher_sequential_fresh_loops_leave_no_stranded_state(executors):
    for side in SIDES:
        batcher = side.Batcher(lambda items: [i + 1 for i in items], max_batch_size=8, flush_delay=0.001,
                               executor=executors(side))

        async def main(batcher=batcher):
            return await asyncio.gather(*(batcher.submit(i) for i in range(20)))

        for _ in range(3):  # three fresh loops, one batcher
            assert asyncio.run(main()) == list(range(1, 21))
        with batcher._lock:
            assert not batcher._pending
            assert not batcher._flushers


def test_batcher_result_count_mismatch_fails_every_waiter(executors):
    for side in SIDES:
        batcher = side.Batcher(lambda items: items[:-1], max_batch_size=8, executor=executors(side))

        async def main(batcher=batcher):
            return await asyncio.gather(batcher.submit(1), batcher.submit(2), return_exceptions=True)

        out = asyncio.run(main())
        assert len(out) == 2
        for exc in out:
            assert isinstance(exc, ValueError) and "results" in str(exc)


def test_batcher_batches_numpy_rows_through_run_batch(executors):
    """The embedder shape: items are rows, the callback stacks them and
    reaches the executor's fixed-shape path inline on the dispatch thread."""
    outs = []
    for side in SIDES:
        ex = executors(side)
        policy = (tdev if side.port else jdev).BucketPolicy(max_bucket=8)
        ex.register("double", lambda x: x * 2.0, policy=policy)
        batcher = side.Batcher(lambda items, ex=ex: list(ex.run_batch("double", (np.stack(items),))),
                               max_batch_size=8, executor=ex)

        async def main(batcher=batcher):
            return await asyncio.gather(*(batcher.submit(np.full(3, i, np.float32)) for i in range(13)))

        outs.append(np.stack(asyncio.run(main())))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6)
    np.testing.assert_allclose(outs[1], 2.0 * np.repeat(np.arange(13, dtype=np.float32)[:, None], 3, axis=1))


def _shed_counter(side, where):
    return side.reg().counter("serve.deadline.exceeded", where=where).value


def test_expired_deadline_is_shed_before_coalescing_and_before_submit(executors):
    for side in SIDES:
        ex = executors(side)
        calls = []
        batcher = side.Batcher(lambda items: calls.append(len(items)) or items, max_batch_size=8, executor=ex)
        before = (_shed_counter(side, "batcher"), _shed_counter(side, "device"))

        async def main(batcher=batcher, side=side):
            with side.serving.deadline_scope(side.serving.Deadline.from_ms(0)):
                return await asyncio.gather(batcher.submit(1), return_exceptions=True)

        [exc] = asyncio.run(main())
        assert isinstance(exc, side.serving.DeadlineExceededError)
        with side.serving.deadline_scope(side.serving.Deadline.from_ms(0)):
            with pytest.raises(side.serving.DeadlineExceededError):
                ex.submit(lambda: "never", name="late")
        assert calls == []
        assert (_shed_counter(side, "batcher"), _shed_counter(side, "device")) == (before[0] + 1, before[1] + 1)


def test_deadline_lapsing_while_pending_is_shed_at_dispatch(executors):
    """A waiter whose deadline lapses while it waits to coalesce is failed
    at dispatch and left out of the batch; the others are served."""
    outs = []
    for side in SIDES:
        ex = executors(side)
        calls = []
        batcher = side.Batcher(lambda items, calls=calls: calls.append(list(items)) or [i * 3 for i in items],
                               max_batch_size=64, flush_delay=0.01, executor=ex)
        real_flush = batcher.flush
        hold_until = time.monotonic() + 0.25

        def gated_flush(real_flush=real_flush, hold_until=hold_until):
            if time.monotonic() < hold_until:
                return
            real_flush()

        batcher.flush = gated_flush
        before = _shed_counter(side, "batcher")

        async def main(batcher=batcher, side=side):
            async def timed(i):
                with side.serving.deadline_scope(side.serving.Deadline.from_ms(100)):
                    return await batcher.submit(i)

            # an undeadlined request comes first: the flusher task copies the
            # context of the request that spawns it, ambient deadline and all
            return await asyncio.gather(batcher.submit(2), timed(1), batcher.submit(4), timed(3),
                                        return_exceptions=True)

        out = asyncio.run(main())
        assert isinstance(out[1], side.serving.DeadlineExceededError)
        assert isinstance(out[3], side.serving.DeadlineExceededError)
        assert out[0] == 6 and out[2] == 12
        assert calls == [[2, 4]]
        assert _shed_counter(side, "batcher") == before + 2
        outs.append((out[0], out[2], calls))
    assert outs[1] == outs[0]

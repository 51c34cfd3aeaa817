"""Async micro-batching: the streaming-to-device coalescing front end.

Counterpart of ``pathway_tpu/utils/batching.py``.  The embedder and
reranker UDFs are async: one coroutine per row, all of an epoch's rows
pending at once.  :class:`AsyncMicroBatcher` coalesces the pending
requests into batches and hands each batch to the device executor's
dispatch queue (``DeviceExecutor.submit``); the model code inside
``process_batch`` reaches the executor's fixed-shape path (``run_batch``)
inline on the dispatch thread.

* One lock-guarded pending list serves every event loop (each epoch runs
  under a fresh ``asyncio.run``; serving threads run their own loops).
  Each waiter remembers its own loop, and results come home through
  ``call_soon_threadsafe``.
* The event loop never blocks on device work: batches run on the
  dispatch thread.
* A request whose ambient serving deadline has lapsed is shed before it
  joins a batch, and again at dispatch, so the device never pays for it.
* A failed batch (a process error, a result-count mismatch, a submit the
  executor refused) fails every waiter of that batch, across loops.
* Each waiter's ambient request trace (``engine/tracing.py``) rides its
  entry: a coalesced batch records a ``serve.batch`` span (the waiter's
  own coalesce wait) in each waiter's trace, and hands the traces to the
  executor, whose ``device.job`` and ``device.dispatch`` spans land in
  each of them too.
"""

from __future__ import annotations

import asyncio
import threading
import time as _time
import weakref
from typing import Any, Callable, Sequence

import numpy as np

from pathway_tpu_torch.device.executor import _JOB_TRACES, DeviceFuture
from pathway_tpu_torch.engine import serving, tracing


def _batch_nbytes(items: list) -> int:
    """Best-effort byte estimate for the executor's in-flight budget."""
    total = 0
    for item in items:
        if isinstance(item, np.ndarray):
            total += item.nbytes
        elif isinstance(item, (bytes, str)):
            total += len(item)
        elif isinstance(item, tuple):
            total += _batch_nbytes(list(item))
    return total


class AsyncMicroBatcher:
    """Coalesces concurrent async submissions into batched process calls.

    ``process_batch(items) -> results`` is the batch callback (typically
    tokenize + ``run_batch``, such as ``SentenceEncoder.encode``), and it
    always runs off the loop.  ``run_in_thread=False`` (embedders and
    rerankers, millisecond batches) routes through the executor's queue;
    ``run_in_thread=True`` (seconds-long batches) runs each batch on a
    thread of its own, so it cannot block the dispatch thread.
    ``executor`` defaults to ``get_default_executor()`` (the first card,
    or an error without one); pass the executor of another device to run
    elsewhere.
    """

    def __init__(
        self,
        process_batch: Callable[[list], Sequence],
        max_batch_size: int = 256,
        flush_delay: float = 0.002,
        run_in_thread: bool = False,
        executor=None,
        name: str | None = None,
    ):
        self.process_batch = process_batch
        self.max_batch_size = max_batch_size
        self.flush_delay = flush_delay
        self.run_in_thread = run_in_thread
        self.name = name or getattr(process_batch, "__name__", "batch")
        self._executor = executor
        # ONE pending list across every event loop: entries are
        # (item, loop, asyncio.Future, Deadline | None,
        # (RequestTrace, enqueued_at) | None)
        self._pending: list[tuple[Any, Any, Any, Any, Any]] = []
        self._lock = threading.Lock()
        # loops with a live flusher task, keyed by id(loop) and validated
        # against a weakref to the loop: a recycled id of a dead loop must
        # not inherit a stale entry
        self._flushers: dict[int, Any] = {}
        # strong refs: the loop holds tasks weakly
        self._tasks: set = set()

    def _exec(self):
        if self._executor is None:
            from pathway_tpu_torch.device import get_default_executor

            self._executor = get_default_executor()
        return self._executor

    async def submit(self, item: Any) -> Any:
        deadline = serving.current_deadline()
        if deadline is not None and deadline.expired():
            serving.note_deadline_shed("batcher")
            raise serving.DeadlineExceededError(
                "request deadline lapsed before batch coalescing (shed-before-work)"
            )
        # the ambient trace is captured here, in the waiter's own context:
        # the dispatch side may run on any thread or loop
        trace = tracing.current_trace()
        entry_trace = (trace, _time.time()) if trace is not None else None
        loop = asyncio.get_running_loop()
        future = loop.create_future()
        flush_now = False
        spawn_flusher = False
        key = id(loop)
        with self._lock:
            self._pending.append((item, loop, future, deadline, entry_trace))
            if len(self._pending) >= self.max_batch_size:
                flush_now = True
            ref = self._flushers.get(key)
            if ref is None or ref() is not loop:  # absent, dead, or recycled id
                self._flushers[key] = weakref.ref(loop)
                spawn_flusher = True
        if spawn_flusher:
            task = loop.create_task(self._flusher(key))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
        if flush_now:
            self.flush()
        return await future

    def flush(self) -> None:
        """Hand every pending item, in batches of ``max_batch_size``, to
        the dispatch queue.  Callable from any thread."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                batch = self._pending[: self.max_batch_size]
                del self._pending[: self.max_batch_size]
            self._dispatch(batch)

    def _dispatch(self, batch: list[tuple[Any, Any, Any, Any, Any]]) -> None:
        # waiters whose deadline lapsed while pending are failed here and
        # left out of the batch
        live = [entry for entry in batch if entry[3] is None or not entry[3].expired()]
        if len(live) < len(batch):
            for _item, loop, fut, ddl, _tr in batch:
                if ddl is not None and ddl.expired():
                    serving.note_deadline_shed("batcher")
                    exc = serving.DeadlineExceededError(
                        "request deadline lapsed while coalescing (shed-before-work)"
                    )
                    _deliver(loop, fut, None, exc)
            if not live:
                return
        # per-waiter coalesce span: one batch, N traces, each waiter's span
        # in its own trace
        now = _time.time()
        traces = []
        for entry in live:
            if entry[4] is not None:
                trace, enqueued_at = entry[4]
                trace.add_span(
                    "serve.batch", enqueued_at, max(0.0, now - enqueued_at),
                    batcher=self.name, batch_size=len(live),
                )
                traces.append(trace)
        items = [entry[0] for entry in live]
        waiters = [(entry[1], entry[2]) for entry in live]

        def job():
            return self.process_batch(items)

        def deliver(device_future: DeviceFuture) -> None:
            try:
                results = list(device_future.result(timeout=0))
                if len(results) != len(waiters):
                    raise ValueError(
                        f"process_batch returned {len(results)} results for {len(waiters)} items"
                    )
                payload = [(res, None) for res in results]
            except BaseException as exc:  # noqa: BLE001 - delivered to every waiter
                payload = [(None, exc)] * len(waiters)
            for (loop, fut), (res, exc) in zip(waiters, payload):
                _deliver(loop, fut, res, exc)

        if self.run_in_thread:
            future = DeviceFuture()

            def run_detached():
                # the batch thread carries the waiters' traces as a
                # dispatch-thread job does, so run_batch calls inside it
                # record their device spans
                token = _JOB_TRACES.set(tuple(traces)) if traces else None
                try:
                    future.set_result(job())
                except BaseException as exc:  # noqa: BLE001 - delivered to waiters
                    future.set_exception(exc)
                finally:
                    if token is not None:
                        _JOB_TRACES.reset(token)

            future.add_done_callback(deliver)
            threading.Thread(target=run_detached, name=f"batch:{self.name}", daemon=True).start()
            return
        try:
            device_future = self._exec().submit(
                job, name=self.name, nbytes=_batch_nbytes(items), traces=tuple(traces)
            )
        except BaseException as exc:  # noqa: BLE001 - delivered to every waiter
            # submit() itself can fail (a closed executor, a budget
            # timeout): every waiter gets the error, none hangs
            for loop, fut in waiters:
                _deliver(loop, fut, None, exc)
            return
        device_future.add_done_callback(deliver)

    async def _flusher(self, key: int) -> None:
        # the first flush is immediate (two zero-sleeps let every
        # submitter of this tick enqueue), so a lone query pays no
        # flush_delay; stragglers are caught by the flush_delay rounds
        loop = asyncio.get_running_loop()
        try:
            await asyncio.sleep(0)
            await asyncio.sleep(0)
            self.flush()
            while True:
                await asyncio.sleep(self.flush_delay)
                with self._lock:
                    if not self._pending:
                        return
                self.flush()
        finally:
            with self._lock:
                # drop only our own entry: a recycled id may hold a newer loop's
                ref = self._flushers.get(key)
                if ref is not None and ref() in (loop, None):
                    self._flushers.pop(key, None)


def _deliver(loop, fut, result, exc) -> None:
    try:
        loop.call_soon_threadsafe(_resolve, fut, result, exc)
    except RuntimeError:
        pass  # the waiter's loop closed before delivery; nobody is listening


def _resolve(fut, result, exc) -> None:
    if fut.done():
        return
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(result)

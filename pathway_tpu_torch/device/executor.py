"""DeviceExecutor: the port's one device-dispatch path.

Counterpart of ``pathway_tpu/device/executor.py``.  Every stock device
caller of the port (the encoder towers, the index top-k, the
micro-batching front end) goes through one executor per device
(:func:`pathway_tpu_torch.device.get_default_executor`):

1. **Fixed shapes.**  :meth:`DeviceExecutor.run_batch` plans a ragged
   numpy batch onto the declared power-of-two buckets
   (``bucketing.py``), pads with zero rows, splits oversized batches,
   copies each chunk to the device, runs the registered callable under
   ``torch.inference_mode()``, copies the output back and slices the
   padding off.  The copy back is the synchronisation point, and it sits
   inside the classified ``try`` and the timed window of
   ``device.dispatch.ms``: a CUDA error or OOM surfaces there.

2. **Cache-key ledger.**  A dispatch's key is every operand and array
   leaf's (shape, dtype), the static keyword arguments and the device.
   PyTorch compiles nothing per key, but the ledger counts first
   dispatches of a key (``device.cache.cold``) so ``warmup`` can pay them
   before traffic (``device.warmup.compiles``), and each key's FLOPs are
   counted once (``telemetry.py``).  The weights of a model are an
   operand, not a closure: two instances of one model share one
   registration and each runs its own weights.

3. **Async dispatch with a bounded in-flight budget.**  :meth:`submit`
   queues a host job onto the dispatch thread and returns a
   :class:`DeviceFuture`.  A full budget (requests and bytes,
   ``PATHWAY_DEVICE_INFLIGHT_REQUESTS``/``_MB``) blocks the submitter and
   the stall is counted (``device.backpressure.s``); the queue exports as
   ``backlog.device.*``.  The dispatch thread (and any thread respawned
   after a hang) sets the executor's CUDA device and enters
   ``torch.inference_mode()`` itself, as both are per thread, and runs
   each job on the stream that was current on the submitting thread.

4. **Cost accounting** (``telemetry.py``): FLOPs per key, device seconds,
   utilization against the roofline peak, padding waste, the batch-size
   distribution and CUDA memory stats.

5. **Fault tolerance** (``resilience.py``): a transient failure is
   retried on a bounded jittered schedule; an out-of-memory chunk is
   split onto the next smaller bucket and the callable's cap ratchets
   down (``device.oom.splits``/``device.bucket.cap``); a per-callable
   circuit breaker trips after consecutive failures and routes batches to
   the host fallback, with half-open probing; a batch that no path can
   serve is quarantined with a typed error; a job that outlives the hard
   dispatch deadline fails its waiters while the dispatch thread is
   written off and respawned (``device.dispatch.restarts``).  Kill
   switch: ``PATHWAY_DEVICE_RESILIENCE=0``.

Two deliberate differences from the reference:

* **Raw CUDA errors.**  Only an out-of-memory error and the fault plan's
  injected errors are classified.  A sticky CUDA error, a hand kernel's
  launch failure or a failed extension build reaches the caller raw: not
  retried, not sent to a fallback, not counted (``resilience.py``).
* **An explicit-only host fallback.**  The reference's fallback defaults
  to the callable itself run un-jitted on the host.  Here it defaults to
  ``None``: a caller that wants one passes a callable running on its own
  ``device="cpu"`` copy of the weights, and every batch it serves counts
  in ``device.fallback.batches``/``rows``.  Without one, a batch the
  device fails (after its retries) is quarantined with
  :class:`DeviceQuarantinedError`, the reference's own terminus when its
  fallback fails.  A kernel therefore never falls back silently.

A wedged dispatch thread is abandoned, never killed: Python cannot kill a
thread.  Only the injected ``device_hang`` (a host sleep) is tested; a
real hung kernel would also block the respawned thread, which launches on
the same stream.

The statistics ``dispatches`` count traffic dispatches only (``warmup``
is not counted there, unlike the reference), and ``warmup`` returns how
many buckets it ran.
"""

from __future__ import annotations

import threading
import time
import traceback
import weakref
from contextvars import ContextVar
from typing import Any, Callable, Sequence

import numpy as np
import torch

from pathway_tpu_torch.device import resilience as _res
from pathway_tpu_torch.device import telemetry as _dtel
from pathway_tpu_torch.device.bucketing import BucketPolicy, pad_batch_dim
from pathway_tpu_torch.engine import faults as _faults
from pathway_tpu_torch.engine import flight_recorder as _blackbox
from pathway_tpu_torch.engine import metrics as _metrics
from pathway_tpu_torch.engine import profiler as _profiler
from pathway_tpu_torch.engine import serving as _serving
from pathway_tpu_torch.internals.config import env_bool, env_float, env_int

# request traces of the job running on the dispatch thread, set by
# ``_run_job`` so ``run_batch`` / ``_run_chunk`` (inline, same thread)
# attribute their device spans to every coalesced waiter's trace
_JOB_TRACES: ContextVar[tuple] = ContextVar("pathway_device_job_traces", default=())
# the attributes of the traced chunk being dispatched on this thread
# (cache cold/warm, retries, fallback), filled by the layers below
# ``_run_chunk`` while a request trace is in scope
_SPAN_NOTE: ContextVar[dict | None] = ContextVar("pathway_device_span_note", default=None)


def _current_traces() -> tuple:
    """Traces device spans attach to: the running job's (the batched submit
    path) or the ambient request trace (an inline ``run_batch``)."""
    traces = _JOB_TRACES.get()
    if traces:
        return traces
    from pathway_tpu_torch.engine import tracing as _tracing

    trace = _tracing.current_trace()
    return (trace,) if trace is not None else ()

__all__ = ["DeviceExecutor", "DeviceFuture"]


class DeviceFuture:
    """Thread-safe future of one queued job; resolves once (a late result
    of an abandoned job cannot overwrite the error its waiters got), and
    waits in 1 s slices."""

    __slots__ = ("_event", "_result", "_exc", "_callbacks", "_lock")

    def __init__(self):
        self._event = threading.Event()
        self._result: Any = None
        self._exc: BaseException | None = None
        self._callbacks: list[Callable[["DeviceFuture"], None]] = []
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, value: Any) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._result = value
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            self._run_callback(cb)

    def set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._exc = exc
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            self._run_callback(cb)

    def _run_callback(self, cb: Callable[["DeviceFuture"], None]) -> None:
        try:
            cb(self)
        except Exception:  # noqa: BLE001 - a bad callback must not kill dispatch
            pass

    def add_done_callback(self, cb: Callable[["DeviceFuture"], None]) -> None:
        """Run ``cb(self)`` once resolved (at once when already done);
        callbacks run on the resolving thread, so keep them cheap."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        self._run_callback(cb)

    def result(self, timeout: float | None = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._event.is_set():
            remaining = 1.0
            if deadline is not None:
                remaining = min(1.0, deadline - time.monotonic())
                if remaining <= 0:
                    raise TimeoutError("device job did not complete in time")
            self._event.wait(timeout=remaining)
        if self._exc is not None:
            raise self._exc
        return self._result


class _Registered:
    """One registered callable: its bucket policy, key ledger, per-key
    costs and resilience state (breaker, retry policy, OOM bucket cap)."""

    __slots__ = (
        "name", "fn", "policy", "host_fallback", "breaker", "retry",
        "bucket_cap", "oom_splits", "fallback_batches", "failure_counts",
        "seen_keys", "costs", "dispatches", "cold", "warmed", "lock",
    )

    def __init__(
        self,
        name: str,
        fn: Callable,
        policy: BucketPolicy,
        *,
        host_fallback: Callable | None,
        breaker: "_res.CircuitBreaker | None",
        retry: "_res.RetryPolicy | None",
    ):
        self.name = name
        self.fn = fn
        self.policy = policy
        self.host_fallback = host_fallback
        self.breaker = breaker
        self.retry = retry
        # OOM ratchet: the largest bucket this callable may still plan
        # (None = uncapped); only ever shrinks
        self.bucket_cap: int | None = None
        self.oom_splits = 0
        self.fallback_batches = 0
        self.failure_counts: dict[str, int] = {}
        self.seen_keys: set[tuple] = set()
        self.costs: dict[tuple, dict[str, float]] = {}
        self.dispatches = 0
        self.cold = 0
        self.warmed = 0
        # guards the ledger only, never held around the device call
        self.lock = threading.Lock()


class _Job:
    """One queued host job (the submit path)."""

    __slots__ = (
        "name", "fn", "future", "nbytes", "stream", "enqueued_at",
        "started_at", "abandoned", "finalized", "traces",
    )

    def __init__(self, name: str, fn: Callable[[], Any], nbytes: int, stream, traces: tuple = ()):
        self.name = name
        self.fn = fn
        self.future = DeviceFuture()
        self.nbytes = max(0, int(nbytes))
        # request traces this job serves (engine/tracing.py), carried
        # explicitly across the submit-to-dispatch thread hop
        self.traces = traces
        # the CUDA stream current on the submitting thread: the job's
        # launches go where the caller's tensors were made
        self.stream = stream
        self.enqueued_at = time.monotonic()
        # set when the job starts; the hang watchdog measures from here
        self.started_at: float | None = None
        # set by the hang escalation: the thread running it is written off
        self.abandoned = False
        # in-flight bytes settled exactly once (loop, escalation or close)
        self.finalized = False


# a module operand's leaf signature, made once per module: the port's
# models never change a tensor's shape or dtype in place (``set_params``
# builds a new module)
_module_sigs: "weakref.WeakKeyDictionary[torch.nn.Module, tuple]" = weakref.WeakKeyDictionary()


def _leaf_sig(x: Any, out: list) -> None:
    """Append the (shape, dtype) of every tensor or array leaf of ``x``."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        out.append((tuple(x.shape), str(x.dtype)))
    elif isinstance(x, torch.nn.Module):
        sig = _module_sigs.get(x)
        if sig is None:
            tensors = list(x.buffers()) + list(x.parameters())
            sig = _module_sigs[x] = tuple((tuple(t.shape), str(t.dtype)) for t in tensors)
        out.extend(sig)
    elif isinstance(x, dict):
        for k in sorted(x, key=str):
            _leaf_sig(x[k], out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _leaf_sig(v, out)
    else:
        out.append(((), type(x).__name__))


def _nbytes(x: Any) -> int:
    """Bytes of every tensor or array leaf of ``x``."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, np.ndarray):
        return x.nbytes
    if isinstance(x, torch.nn.Module):
        return sum(_nbytes(t) for t in x.buffers()) + sum(_nbytes(t) for t in x.parameters())
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _to_host(out: Any) -> Any:
    """The callable's output (a tensor, or a tuple or list of them) as
    numpy: the copy back that waits for the device (counted under
    ``device.transfer.d2h.bytes`` with ``PATHWAY_PROFILE_TRANSFERS``)."""
    if isinstance(out, torch.Tensor):
        _profiler.note_d2h(out.numel() * out.element_size())
        return out.cpu().numpy()
    if isinstance(out, list):
        return [_to_host(o) for o in out]
    if isinstance(out, tuple):
        return tuple(_to_host(o) for o in out)
    return np.asarray(out)


def _release_frames(exc: BaseException) -> None:
    """Clear the finished frames held by ``exc``'s tracebacks (and its
    cause's): an out-of-memory error must not keep the failed call's
    tensors alive while the batch is planned again at a smaller bucket."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if exc.__traceback__ is not None:
            traceback.clear_frames(exc.__traceback__)
        exc = exc.__cause__ or exc.__context__


class DeviceExecutor:
    """Bucketed, ledgered, async, fault-tolerant dispatch onto one device
    (one per device in practice: ``get_default_executor``)."""

    def __init__(
        self,
        device: str | torch.device | None = None,
        *,
        max_inflight_mb: float | None = None,
        max_inflight_requests: int | None = None,
        collector_name: str | None = "device.executor",
    ):
        from pathway_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        if max_inflight_mb is None:
            max_inflight_mb = env_float("PATHWAY_DEVICE_INFLIGHT_MB")
        if max_inflight_requests is None:
            max_inflight_requests = env_int("PATHWAY_DEVICE_INFLIGHT_REQUESTS")
        self._default_max_batch = int(env_int("PATHWAY_DEVICE_MAX_BATCH"))
        self.max_inflight_bytes = int(float(max_inflight_mb) * 1024 * 1024)
        self.max_inflight_requests = int(max_inflight_requests)
        self._callables: dict[str, _Registered] = {}
        self._queue: list[_Job] = []
        self._running: _Job | None = None
        self._inflight_bytes = 0
        self._cond = threading.Condition()
        self._thread: threading.Thread | None = None
        self._stop = False
        self._closed = False
        # bumped on every dispatch-thread (re)spawn: a loop whose generation
        # is superseded (written off by a hang escalation) exits
        self._thread_gen = 0
        self._watchdog: threading.Thread | None = None
        self._resilience = env_bool("PATHWAY_DEVICE_RESILIENCE")
        self._dispatch_deadline_s = float(env_float("PATHWAY_DEVICE_DISPATCH_DEADLINE_S") or 0.0)
        # never set but by close(): timed waits on it make retry backoff
        # interruptible
        self._retry_interrupt = threading.Event()
        self._quarantine = _res.QuarantineLog.from_env()
        reg = _metrics.get_registry()
        self._m_batches = reg.counter("device.dispatch.batches", "fixed-shape device batches dispatched")
        self._m_rows = reg.counter("device.dispatch.rows", "real rows dispatched through the executor")
        self._m_pad = reg.counter("device.pad.rows", "padding rows added by bucketing")
        self._m_cold = reg.counter("device.cache.cold", "first dispatches of a new cache key")
        self._m_warm = reg.counter("device.warmup.compiles", "cache keys paid ahead by warmup()")
        self._m_jobs = reg.counter("device.jobs", "async host-side batch jobs dispatched")
        self._m_backpressure = reg.counter(
            "device.backpressure.s", "seconds submitters stalled on the in-flight budget"
        )
        self._m_dispatch_ms = reg.histogram(
            "device.dispatch.ms", "wall time of one dispatched device call (ms)", buckets=_metrics.MS_BUCKETS
        )
        self._m_job_ms = reg.histogram(
            "device.job.ms", "wall time of one async host-side batch job (ms)", buckets=_metrics.MS_BUCKETS
        )
        self._m_occupancy = reg.histogram(
            "device.bucket.occupancy",
            "real-row fraction of each dispatched bucket (1.0 = no padding)",
            buckets=_metrics.OCCUPANCY_BUCKETS,
        )
        self._m_retries = reg.counter(
            "device.retry.attempts", "transient device failures retried by the dispatch wrapper"
        )
        self._m_oom_splits = reg.counter(
            "device.oom.splits", "out-of-memory chunks split onto smaller buckets"
        )
        self._m_breaker_trips = reg.counter(
            "device.breaker.trips", "circuit-breaker open transitions"
        )
        self._m_fb_batches = reg.counter("device.fallback.batches", "batches served by the host fallback")
        self._m_fb_rows = reg.counter("device.fallback.rows", "real rows served by the host fallback")
        self._m_fb_ms = reg.histogram(
            "device.fallback.ms", "wall time of one host-fallback batch (ms)", buckets=_metrics.MS_BUCKETS
        )
        self._m_quarantine = reg.counter(
            "device.quarantine.batches", "poisoned batches quarantined (no path could serve them)"
        )
        self._m_restarts = reg.counter(
            "device.dispatch.restarts", "dispatch threads written off and respawned after a hang"
        )
        self._reg = reg
        self._accountant = _dtel.CostAccountant(registry=reg, device=self.device)
        # this executor's own padding totals (the registry counters are
        # shared by every executor)
        self._pad_rows = 0
        self._real_rows = 0
        # the in-flight footprint of running dispatches: the memory figure
        # where the device keeps no allocator stats (the CPU)
        self._mem_lock = threading.Lock()
        self._live_bytes = 0.0
        self._live_peak = 0.0
        if collector_name:
            reg.register_collector(collector_name, self.metrics_snapshot)

    # -- registration and the key ledger -------------------------------------

    def register(
        self,
        name: str,
        fn: Callable,
        *,
        policy: BucketPolicy | None = None,
        host_fallback: Callable | None = None,
    ) -> str:
        """Register ``fn`` under ``name``; it is called as
        ``fn(*operands, *tensors, **static)`` with the arrays as tensors on
        the executor's device, batch axis padded to a bucket.

        ``host_fallback``, called the same way with the padded arrays as
        CPU tensors, serves batches while the breaker is open or after a
        device failure; it should run on its own ``device="cpu"`` copy of
        the weights.  Without one such a batch is quarantined.
        Re-registering a name replaces the callable and resets its ledger
        and resilience state."""
        if policy is None:
            policy = BucketPolicy(max_bucket=env_int("PATHWAY_DEVICE_MAX_BATCH"))
        self._callables[name] = _Registered(
            name,
            fn,
            policy,
            host_fallback=host_fallback,
            breaker=_res.CircuitBreaker.from_env() if self._resilience else None,
            retry=_res.RetryPolicy.from_env() if self._resilience else None,
        )
        return name

    def set_resilience(self, on: bool) -> None:
        """Toggle the fault-tolerance rail at run time (the benchmark
        lever): off bypasses the routing and keeps breakers, caps and
        ledgers; on creates the state callables registered while off lack."""
        self._resilience = bool(on)
        if on:
            for entry in self._callables.values():
                if entry.breaker is None:
                    entry.breaker = _res.CircuitBreaker.from_env()
                if entry.retry is None:
                    entry.retry = _res.RetryPolicy.from_env()

    def registered(self, name: str) -> bool:
        return name in self._callables

    def costs(self, name: str) -> dict[tuple, dict[str, float]]:
        """The counted cost of each of ``name``'s cache keys."""
        entry = self._callables[name]
        with entry.lock:
            return {k: dict(v) for k, v in entry.costs.items()}

    def stats(self, name: str) -> dict[str, int]:
        entry = self._callables[name]
        with entry.lock:
            return {
                "dispatches": entry.dispatches,
                "cold": entry.cold,
                "warmed": entry.warmed,
                "keys": len(entry.seen_keys),
            }

    def dispatches(self, name: str) -> int:
        """How many fixed-shape chunks ``name`` has run (warmup excluded)."""
        return self._callables[name].dispatches

    def _cache_key(self, operands: tuple, arrays: tuple, static: dict[str, Any] | None) -> tuple:
        leaves: list[tuple] = []
        _leaf_sig(operands, leaves)
        _leaf_sig(arrays, leaves)
        static_key = tuple(sorted((static or {}).items()))
        return (tuple(leaves), static_key, str(self.device))

    def _dispatch_fixed(
        self,
        entry: _Registered,
        operands: tuple,
        arrays: tuple,
        static: dict[str, Any] | None,
        *,
        warmup: bool = False,
    ) -> Any:
        """One fixed-shape call: copy the padded arrays in, run, copy the
        output back (numpy).  A key's first call that has no cost yet runs
        under the FLOP count and stays out of the accountant's ledger."""
        static = static or {}
        key = self._cache_key(operands, arrays, static)
        with entry.lock:
            fresh = key not in entry.seen_keys
            if fresh:
                entry.seen_keys.add(key)
                if warmup:
                    entry.warmed += 1
                else:
                    entry.cold += 1
            if not warmup:
                entry.dispatches += 1
            cost = entry.costs.get(key)
        note = _SPAN_NOTE.get()
        if note is not None:
            note["cache"] = "cold" if fresh else "warm"
        if fresh:
            (self._m_warm if warmup else self._m_cold).inc()
        counting = cost is None and env_bool("PATHWAY_DEVICE_COST_ANALYSIS")
        footprint = 0.0
        if self._accountant.enabled:
            footprint = (
                cost["argument_bytes"] + cost["output_bytes"] + cost["temp_bytes"]
                if cost
                else float(sum(a.nbytes for a in arrays))
            )
            with self._mem_lock:
                self._live_bytes += footprint
                self._live_peak = max(self._live_peak, self._live_bytes)
        t0 = time.monotonic()
        try:
            # injection sits inside the dispatch, so an injected failure
            # takes the path a real one would
            self._maybe_inject_failure(entry.name)
            with torch.inference_mode():
                tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays]
                _profiler.note_h2d(sum(a.nbytes for a in arrays))

                def call():
                    return _to_host(entry.fn(*operands, *tensors, **static))

                if counting:
                    out, counted = _dtel.count_cost(call)
                else:
                    out = call()
        finally:
            if footprint:
                with self._mem_lock:
                    self._live_bytes -= footprint
        duration = time.monotonic() - t0
        self._m_dispatch_ms.observe(duration * 1000.0)
        self._m_batches.inc()
        if counting:
            counted["argument_bytes"] = float(_nbytes(operands) + sum(a.nbytes for a in arrays))
            counted["output_bytes"] = float(_nbytes(out))
            counted["bytes_accessed"] = counted["argument_bytes"] + counted["output_bytes"]
            with entry.lock:
                entry.costs[key] = counted
        else:
            self._accountant.record_dispatch(cost, duration)
        return out

    # -- fault classification, retry, fallback, quarantine --------------------

    def _maybe_inject_failure(self, name: str) -> None:
        """``device_error``/``device_oom``/``device_compile_fail`` injection,
        raised inside the dispatch with the reference's messages."""
        plan = _faults.active_plan()
        if plan is None:
            return
        if plan.check("device_error", source=name) is not None:
            raise _res.InjectedDeviceError(f"INTERNAL: injected transient device failure ({name})")
        if plan.check("device_oom", source=name) is not None:
            raise _res.InjectedDeviceError(f"RESOURCE_EXHAUSTED: injected device OOM ({name})")
        if plan.check("device_compile_fail", source=name) is not None:
            raise _res.InjectedDeviceError(f"injected XLA compilation failure ({name})")

    def _count_failure(self, entry: _Registered, kind: str, exc: BaseException) -> None:
        with entry.lock:
            entry.failure_counts[kind] = entry.failure_counts.get(kind, 0) + 1
        self._reg.counter(
            "device.failures", "classified device-path failures observed (kind label)", kind=kind
        ).inc()
        _blackbox.record("device.failure", callable=entry.name, failure=kind, error=str(exc)[:200])

    def _dispatch_with_retry(
        self,
        entry: _Registered,
        operands: tuple,
        arrays: tuple,
        static: dict[str, Any] | None,
        *,
        warmup: bool = False,
    ) -> Any:
        """One fixed-shape dispatch under the typed-failure contract:
        unclassified errors propagate raw; classified ones are counted and,
        for transients only, retried on the bounded jittered schedule
        (materialised on the first failure), within the retry deadline.
        The backoff wait runs after the handler has let the error go."""
        retry = entry.retry
        delays = None
        deadline = 0.0
        attempt = 0
        while True:
            try:
                return self._dispatch_fixed(entry, operands, arrays, static, warmup=warmup)
            except Exception as exc:  # noqa: BLE001 - classified below
                typed = _res.classify(exc)
                if typed is None:
                    raise
                self._count_failure(entry, typed.kind, exc)
                if typed is exc:
                    raise
                if retry is None or typed.kind != "transient":
                    raise typed from exc
                if delays is None:
                    delays = retry.delays()
                    deadline = time.monotonic() + retry.deadline_s
                attempt += 1
                note = _SPAN_NOTE.get()
                if note is not None:
                    note["retries"] = attempt
                remaining = deadline - time.monotonic()
                if attempt > retry.retries or remaining <= 0:
                    raise typed from exc
                wait_s = min(next(delays), max(0.0, remaining))
            self._m_retries.inc()
            self._retry_interrupt.wait(timeout=wait_s)
            if self._closed:
                raise _res.ExecutorClosedError("device executor closed during retry backoff")

    def _ratchet(self, entry: _Registered, cap: int, error: str) -> None:
        """Shrink the callable's largest bucket (only ever downward)."""
        with entry.lock:
            entry.bucket_cap = cap if entry.bucket_cap is None else min(entry.bucket_cap, cap)
            entry.oom_splits += 1
            new_cap = entry.bucket_cap
        self._m_oom_splits.inc()
        self._reg.gauge(
            "device.bucket.cap", "largest bucket a callable may plan after OOM ratcheting", callable=entry.name
        ).set(float(new_cap))
        _blackbox.record("device.oom.ratchet", callable=entry.name, cap=new_cap, error=error[:200])

    def _run_host_fallback(
        self, entry: _Registered, operands: tuple, padded: tuple, static: dict[str, Any] | None
    ) -> Any:
        """The registered host fallback on the same padded rows, as CPU
        tensors."""
        fb = entry.host_fallback
        if fb is None:
            raise RuntimeError(f"no host fallback registered for {entry.name!r}")
        t0 = time.monotonic()
        with torch.inference_mode():
            tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in padded]
            out = _to_host(fb(*operands, *tensors, **(static or {})))
        self._m_fb_ms.observe((time.monotonic() - t0) * 1000.0)
        return out

    def _quarantine_batch(
        self,
        entry: _Registered,
        padded: tuple,
        count: int,
        device_exc: BaseException | None,
        fallback_exc: BaseException,
    ) -> None:
        record = self._quarantine.add(entry.name, count, padded, device_exc, fallback_exc)
        self._m_quarantine.inc()
        _blackbox.record(
            "device.quarantine",
            callable=entry.name,
            rows=count,
            device_error=record["device_error"],
            fallback_error=record["fallback_error"],
        )

    def _ledger(self, count: int, bucket: int) -> None:
        """Padding and occupancy of one chunk that served at ``bucket``."""
        self._m_rows.inc(count)
        self._m_pad.inc(bucket - count)
        self._m_occupancy.observe(count / bucket)
        with self._mem_lock:
            self._real_rows += count
            self._pad_rows += bucket - count

    def _run_chunk(
        self,
        entry: _Registered,
        operands: tuple,
        rows: tuple,
        count: int,
        bucket: int,
        static: dict[str, Any] | None,
    ) -> list[Any]:
        """Dispatch one planned chunk; when request traces are in scope (a
        traced job on the dispatch thread, or an ambient trace around an
        inline ``run_batch``), the chunk records a ``device.dispatch`` span
        per trace: callable, bucket and rows, and the cache, retries and
        fallback attributes the layers below note."""
        traces = _current_traces()
        if not traces:
            return self._run_chunk_inner(entry, operands, rows, count, bucket, static)
        note: dict[str, Any] = {}
        token = _SPAN_NOTE.set(note)
        started = time.time()
        t0 = time.monotonic()
        try:
            return self._run_chunk_inner(entry, operands, rows, count, bucket, static)
        finally:
            _SPAN_NOTE.reset(token)
            duration_s = time.monotonic() - t0
            for trace in traces:
                trace.add_span(
                    "device.dispatch", started, duration_s,
                    callable=entry.name, bucket=bucket, rows=count, **note,
                )

    def _run_chunk_inner(
        self,
        entry: _Registered,
        operands: tuple,
        rows: tuple,
        count: int,
        bucket: int,
        static: dict[str, Any] | None,
    ) -> list[Any]:
        """Dispatch one planned chunk under the resilience contract; returns
        its unpadded outputs, possibly from several smaller dispatches after
        an OOM ratchet."""
        padded = tuple(pad_batch_dim(r, bucket)[0] for r in rows)
        breaker = entry.breaker if self._resilience else None
        if breaker is None:
            out = self._dispatch_fixed(entry, operands, padded, static)
            self._ledger(count, bucket)
            return [_slice_rows(out, count)]
        route = breaker.admit()
        probe = route == "probe"
        device_exc: BaseException | None = None
        if route != "fallback":
            replan = False
            try:
                out = self._dispatch_with_retry(entry, operands, padded, static)
            except _res.ExecutorClosedError:
                # close() interrupted a backoff: no breaker count, no
                # fallback on a closed executor
                if probe:
                    breaker.abort_probe()
                raise
            except _res.DeviceOOMError as exc:
                _release_frames(exc)
                smaller = entry.policy.next_smaller(bucket)
                if smaller is not None:
                    # the device answered, it is only out of memory: the
                    # ratchet, not the breaker, owns this
                    breaker.record_success(probe=probe)
                    self._ratchet(entry, smaller, str(exc))
                    replan = True
                else:
                    device_exc = exc
                    if breaker.record_failure(probe=probe):
                        self._on_breaker_trip(entry)
            except _res.DeviceJobError as exc:
                device_exc = exc
                if breaker.record_failure(probe=probe):
                    self._on_breaker_trip(entry)
            except BaseException:
                # a raw error: the probe's outcome will never be reported,
                # so release the slot or the breaker latches open
                if probe:
                    breaker.abort_probe()
                raise
            else:
                if breaker.record_success(probe=probe):
                    _blackbox.record("device.breaker.close", callable=entry.name)
                self._ledger(count, bucket)
                return [_slice_rows(out, count)]
            if replan:
                # planned again only now, after the handler let the error
                # (and the failed call's tensors) go
                return self._run_rows(entry, operands, rows, count, static)
        # degraded mode: the host fallback serves this batch
        note = _SPAN_NOTE.get()
        if note is not None:
            note["fallback"] = True
        try:
            out = self._run_host_fallback(entry, operands, padded, static)
        except Exception as exc:  # noqa: BLE001 - the poisoned-batch terminus
            self._quarantine_batch(entry, padded, count, device_exc, exc)
            device_part = (
                f"device failed ({device_exc})" if device_exc is not None else "device not attempted (breaker open)"
            )
            raise _res.DeviceQuarantinedError(
                f"batch quarantined for {entry.name!r}: {device_part}; host fallback failed ({exc})"
            ) from exc
        with entry.lock:
            entry.fallback_batches += 1
        self._m_fb_batches.inc()
        self._m_fb_rows.inc(count)
        _blackbox.record("device.fallback", callable=entry.name, rows=count)
        self._ledger(count, bucket)
        return [_slice_rows(out, count)]

    def _on_breaker_trip(self, entry: _Registered) -> None:
        self._m_breaker_trips.inc()
        _blackbox.record(
            "device.breaker.open",
            callable=entry.name,
            threshold=entry.breaker.threshold if entry.breaker else 0,
        )

    def _run_rows(
        self,
        entry: _Registered,
        operands: tuple,
        arrays: tuple,
        n_rows: int,
        static: dict[str, Any] | None,
    ) -> list[Any]:
        """Plan ``n_rows`` under the callable's current bucket cap and
        dispatch every chunk; entered again when a ratchet re-plans a
        chunk at a smaller cap."""
        outs: list[Any] = []
        with entry.lock:
            cap = entry.bucket_cap
        for chunk in entry.policy.plan(n_rows, cap=cap):
            rows = tuple(a[chunk.start : chunk.start + chunk.count] for a in arrays)
            outs.extend(self._run_chunk(entry, operands, rows, chunk.count, chunk.bucket, static))
        return outs

    # -- the fixed-shape inline path -----------------------------------------

    def run_batch(
        self,
        name: str,
        arrays: Sequence[np.ndarray],
        n_rows: int | None = None,
        *,
        operands: Sequence[Any] = (),
        static: dict[str, Any] | None = None,
    ) -> Any:
        """Run a ragged batch (``arrays`` share a leading batch axis of
        ``n_rows``) through the registered callable; returns its output (an
        array, or a tuple or list of arrays) as numpy with the padding
        sliced off and the chunks concatenated back in order.

        Runs on the calling thread, so it is safe inside a dispatch-thread
        job (use :meth:`submit` for async).  Transients retry, an
        out-of-memory chunk splits, persistent failures trip the breaker to
        the host fallback, and a batch no path can serve raises
        :class:`DeviceQuarantinedError`; unclassified errors (host bugs,
        CUDA errors) propagate raw."""
        if self._closed and not (
            self._thread is not None and threading.current_thread() is self._thread
        ):
            # the dispatch thread stays admitted, so close()'s drain window
            # can finish queued jobs that route through run_batch
            raise _res.ExecutorClosedError("run_batch() on a closed device executor")
        entry = self._callables[name]
        arrays = tuple(np.asarray(a) for a in arrays)
        if n_rows is None:
            n_rows = arrays[0].shape[0]
        if n_rows == 0:
            raise ValueError("cannot dispatch an empty batch")
        for a in arrays:
            if a.shape[0] != n_rows:
                raise ValueError(f"batch arrays disagree on row count: {a.shape[0]} != {n_rows}")
        operands = tuple(operands)
        self._accountant.record_batch(n_rows)
        chunk_outs = self._run_rows(entry, operands, arrays, n_rows, static)
        if len(chunk_outs) == 1:
            return chunk_outs[0]
        return _concat_rows(chunk_outs)

    def warmup(
        self,
        name: str,
        row_shapes: Sequence[tuple[int, ...]],
        dtypes: Sequence[Any],
        *,
        operands: Sequence[Any] = (),
        static: dict[str, Any] | None = None,
        buckets: Sequence[int] | None = None,
    ) -> int:
        """Run ``name`` once on all-zero arrays at every bucket of its
        policy (or at ``buckets``) before traffic, paying each key's cold
        dispatch and FLOP count; ``row_shapes``/``dtypes`` describe one row
        of each array.  Returns how many buckets ran.  Under the rail a
        transient retries and a persistent failure raises typed."""
        entry = self._callables[name]
        if buckets is None:
            buckets = entry.policy.buckets()
        for bucket in buckets:
            arrays = tuple(
                np.zeros((bucket,) + tuple(shape), dtype=dtype) for shape, dtype in zip(row_shapes, dtypes)
            )
            if self._resilience:
                self._dispatch_with_retry(entry, tuple(operands), arrays, static, warmup=True)
            else:
                self._dispatch_fixed(entry, tuple(operands), arrays, static, warmup=True)
        return len(buckets)

    # -- the async host-job path ---------------------------------------------

    def submit(
        self,
        fn: Callable[[], Any],
        *,
        name: str = "host",
        nbytes: int = 0,
        timeout_s: float | None = None,
        traces: tuple = (),
    ) -> DeviceFuture:
        """Queue ``fn()`` onto the dispatch thread; returns its future.

        Blocks (bounded, counted) while the in-flight budget of requests
        and bytes is spent: that stall is the backpressure signal
        (``device.backpressure.s``, ``backlog.device.*``).  Sheds a request
        whose ambient deadline has lapsed before queueing anything.  Never
        call it from the dispatch thread: a job there calls
        :meth:`run_batch` inline."""
        if self._thread is not None and threading.current_thread() is self._thread:
            raise RuntimeError(
                "submit() called from the dispatch thread — run_batch() is the inline API "
                "for dispatch-side device work"
            )
        if self._closed:
            raise _res.ExecutorClosedError("submit() on a closed device executor")
        _serving.shed_if_expired("device")
        stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        if not traces:
            # a direct submit (no batcher in front) carries the ambient
            # request trace of the submitting context
            traces = _current_traces()
        job = _Job(name, fn, nbytes, stream, traces)
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        stalled = 0.0
        try:
            with self._cond:
                while self._over_budget():
                    if deadline is not None and time.monotonic() >= deadline:
                        raise TimeoutError("device executor in-flight budget full past deadline")
                    if self._closed:
                        raise _res.ExecutorClosedError(
                            "device executor closed while submit() waited on the in-flight budget"
                        )
                    t0 = time.monotonic()
                    self._cond.wait(timeout=0.1)
                    stalled += time.monotonic() - t0
                if self._closed:
                    # close() may have freed the budget and woken this
                    # waiter: queueing now would revive the dispatch thread
                    raise _res.ExecutorClosedError(
                        "device executor closed while submit() waited on the in-flight budget"
                    )
                self._inflight_bytes += job.nbytes
                self._queue.append(job)
                self._ensure_thread()
                self._cond.notify_all()
        finally:
            if stalled:
                self._m_backpressure.inc(stalled)
        return job.future

    def _over_budget(self) -> bool:
        inflight = len(self._queue) + (1 if self._running is not None else 0)
        return inflight >= self.max_inflight_requests or self._inflight_bytes >= self.max_inflight_bytes

    def _ensure_thread(self) -> None:
        """(Re)spawn the dispatch thread; the caller holds ``_cond``."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = False
        self._thread_gen += 1
        self._thread = threading.Thread(
            target=self._dispatch_loop, args=(self._thread_gen,), name="device-dispatch", daemon=True
        )
        self._thread.start()
        if self._dispatch_deadline_s > 0 and (self._watchdog is None or not self._watchdog.is_alive()):
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="device-dispatch-watchdog", daemon=True
            )
            self._watchdog.start()

    def _dispatch_loop(self, gen: int) -> None:
        # the current CUDA device and inference mode are per thread: set
        # both here, on this thread, before any job runs
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            while True:
                with self._cond:
                    while not self._queue and not self._stop and self._thread_gen == gen:
                        self._cond.wait(timeout=1.0)
                    if self._thread_gen != gen:
                        return  # written off by a hang escalation
                    if self._stop and not self._queue:
                        return
                    job = self._queue.pop(0)
                    job.started_at = time.monotonic()
                    self._running = job
                try:
                    self._run_job(job)
                finally:
                    with self._cond:
                        # settle the in-flight bytes exactly once: a hang
                        # escalation or close() may have done it already
                        if not job.finalized:
                            job.finalized = True
                            self._inflight_bytes -= job.nbytes
                        if self._running is job:
                            self._running = None
                        superseded = self._thread_gen != gen
                        self._cond.notify_all()
                    if superseded:
                        return

    def _run_job(self, job: _Job) -> None:
        self._maybe_stall(job)
        self._maybe_hang(job)
        if job.abandoned:
            return  # the injected hang outlived the deadline: its waiters were failed
        t0 = time.monotonic()
        started = time.time()
        token = _JOB_TRACES.set(job.traces) if job.traces else None
        try:
            if job.stream is not None:
                with torch.cuda.stream(job.stream):
                    result = job.fn()
            else:
                result = job.fn()
        except BaseException as exc:  # noqa: BLE001 - delivered to the waiter
            job.future.set_exception(exc)
            return
        finally:
            if token is not None:
                _JOB_TRACES.reset(token)
            if job.traces:
                duration_s = time.monotonic() - t0
                queue_wait_s = max(0.0, t0 - job.enqueued_at)
                for trace in job.traces:
                    trace.add_span(
                        "device.job",
                        started,
                        duration_s,
                        job=job.name,
                        queue_wait_s=round(queue_wait_s, 6),
                    )
        if job.abandoned:
            return  # its waiters already got the hang error
        self._m_job_ms.observe((time.monotonic() - t0) * 1000.0)
        self._m_jobs.inc()
        job.future.set_result(result)

    def _maybe_stall(self, job: _Job) -> None:
        """``device_stall`` injection: delay the job, raise nothing."""
        spec = _faults.check("device_stall", source=job.name)
        if spec is None:
            return
        deadline = time.monotonic() + spec.delay_ms / 1000.0
        while time.monotonic() < deadline and not self._stop:
            time.sleep(0.05)

    def _maybe_hang(self, job: _Job) -> None:
        """``device_hang`` injection: wedge the dispatch thread on this job
        (a host sleep bounded by ``delay_ms``, default 60 s) until the hard
        dispatch deadline ends it."""
        spec = _faults.check("device_hang", source=job.name)
        if spec is None:
            return
        _blackbox.record("fault.device_hang", job=job.name)
        limit = time.monotonic() + (spec.delay_ms or 60_000.0) / 1000.0
        while time.monotonic() < limit and not self._stop and not job.abandoned:
            time.sleep(0.05)

    def _watchdog_loop(self) -> None:
        """Fail a running job older than the dispatch deadline with a typed
        hang error and hand the queue to a fresh dispatch thread."""
        while True:
            with self._cond:
                if self._stop:
                    return
                job = self._running
                started = job.started_at if job is not None else None
                self._cond.wait(timeout=0.1)
            if job is not None and started is not None and time.monotonic() - started > self._dispatch_deadline_s:
                self._escalate_hang(job)

    def _escalate_hang(self, job: _Job) -> None:
        with self._cond:
            if job.finalized or self._running is not job:
                return
            job.abandoned = True
            job.finalized = True
            self._running = None
            self._inflight_bytes -= job.nbytes
            age = time.monotonic() - (job.started_at or job.enqueued_at)
            self._thread = None
            if not self._stop and not self._closed:
                self._ensure_thread()
            else:
                self._thread_gen += 1
            self._cond.notify_all()
        self._m_restarts.inc()
        self._reg.counter(
            "device.failures", "classified device-path failures observed (kind label)", kind="hang"
        ).inc()
        _blackbox.record(
            "device.dispatch.restart", job=job.name, age_s=round(age, 3), deadline_s=self._dispatch_deadline_s
        )
        job.future.set_exception(
            _res.DeviceDispatchHangError(
                f"dispatch of job {job.name!r} exceeded the hard deadline "
                f"({self._dispatch_deadline_s:g} s); the dispatch thread was restarted"
            )
        )

    def close(self, timeout_s: float = 5.0) -> None:
        """Refuse new work, drain what the dispatch thread finishes within
        ``timeout_s``, and fail every waiter still in flight with a typed
        :class:`ExecutorClosedError` (never strand one)."""
        with self._cond:
            self._closed = True
            self._stop = True
            self._retry_interrupt.set()
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout_s)
        leftovers: list[_Job] = []
        with self._cond:
            if thread is not None and thread.is_alive():
                # wedged past the drain budget: write the thread off and
                # fail its job
                self._thread_gen += 1
                running = self._running
                if running is not None and not running.finalized:
                    running.abandoned = True
                    running.finalized = True
                    self._inflight_bytes -= running.nbytes
                    leftovers.append(running)
                    self._running = None
            while self._queue:
                job = self._queue.pop(0)
                if not job.finalized:
                    job.finalized = True
                    self._inflight_bytes -= job.nbytes
                leftovers.append(job)
            self._cond.notify_all()
        for job in leftovers:
            job.future.set_exception(
                _res.ExecutorClosedError(f"device executor closed before job {job.name!r} completed")
            )

    # -- observability -------------------------------------------------------

    def _queue_snapshot(self) -> dict[str, float]:
        """The ``backlog.device.*`` slice: queue depth, bytes, oldest age."""
        with self._cond:
            jobs = list(self._queue)
            if self._running is not None:
                jobs.append(self._running)
            inflight_bytes = self._inflight_bytes
        now = time.monotonic()
        return {
            "backlog.device.queue": float(len(jobs)),
            "backlog.device.bytes": float(inflight_bytes),
            "backlog.device.age.s": max(0.0, now - min(j.enqueued_at for j in jobs)) if jobs else 0.0,
        }

    def _padding_snapshot(self) -> dict[str, float]:
        with self._mem_lock:
            pad, real = self._pad_rows, self._real_rows
        total = pad + real
        return {"pad_rows": float(pad), "real_rows": float(real), "fraction": (pad / total) if total else 0.0}

    def _hbm_snapshot(self) -> dict[str, Any]:
        """The caching allocator's numbers on a card, else the tracked
        in-flight footprint."""
        stats = _dtel.hbm_stats(self.device)
        if stats is not None:
            return {**stats, "source": "memory_stats"}
        with self._mem_lock:
            return {"bytes_in_use": self._live_bytes, "peak": self._live_peak, "source": "executor"}

    def metrics_snapshot(self) -> dict[str, float]:
        """Registry collector: ``backlog.device.*``, the cost gauges,
        padding waste, memory and each callable's breaker state and cap."""
        out = self._queue_snapshot()
        out.update(self._accountant.gauges())
        out["device.batch.max"] = float(self._default_max_batch)
        padding = self._padding_snapshot()
        out["device.padding.waste.rows"] = padding["pad_rows"]
        out["device.padding.waste.fraction"] = padding["fraction"]
        hbm = self._hbm_snapshot()
        out["device.hbm.bytes_in_use"] = float(hbm["bytes_in_use"])
        out["device.hbm.peak"] = float(hbm["peak"])
        for name, entry in sorted(self._callables.items()):
            if entry.breaker is not None:
                out[f"device.breaker.state{{callable={name}}}"] = entry.breaker.state_value()
            with entry.lock:
                cap = entry.bucket_cap
            if cap is not None:
                out[f"device.bucket.cap{{callable={name}}}"] = float(cap)
        out["device.quarantine.records"] = float(len(self._quarantine))
        if self.device.type != "cpu" or not torch.cuda.is_available():
            return out
        # a host twin's executor beside a card: its gauges carry
        # ``device=cpu``, so they do not shadow the card's unlabelled ones
        # in the registry's flat namespace
        return {(f"{k[:-1]},device=cpu}}" if k.endswith("}") else f"{k}{{device=cpu}}"): v for k, v in out.items()}

    def resilience_stats(self, name: str) -> dict[str, Any]:
        """One callable's fault-tolerance ledger."""
        entry = self._callables[name]
        with entry.lock:
            out: dict[str, Any] = {
                "bucket_cap": entry.bucket_cap,
                "oom_splits": entry.oom_splits,
                "fallback_batches": entry.fallback_batches,
                "failures": dict(entry.failure_counts),
            }
        out["breaker"] = entry.breaker.snapshot() if entry.breaker is not None else None
        return out

    def quarantine_records(self) -> list[dict[str, Any]]:
        return self._quarantine.records()

    def device_snapshot(self) -> dict[str, Any]:
        """The whole device story as one JSON-able dict."""
        return {
            "device": str(self.device),
            "cost": self._accountant.snapshot(),
            "default_max_batch": self._default_max_batch,
            "padding": self._padding_snapshot(),
            "hbm": self._hbm_snapshot(),
            "queue": self._queue_snapshot(),
            "callables": {name: self.stats(name) for name in sorted(self._callables)},
            "resilience": {
                "enabled": self._resilience,
                "dispatch_deadline_s": self._dispatch_deadline_s,
                "callables": {name: self.resilience_stats(name) for name in sorted(self._callables)},
                "quarantine": self.quarantine_records(),
            },
        }


def _slice_rows(out: Any, count: int) -> Any:
    if isinstance(out, (tuple, list)):
        return type(out)(o[:count] for o in out)
    return out[:count]


def _concat_rows(chunks: list[Any]) -> Any:
    first = chunks[0]
    if isinstance(first, (tuple, list)):
        return type(first)(np.concatenate([c[i] for c in chunks], axis=0) for i in range(len(first)))
    return np.concatenate(chunks, axis=0)


def __getattr__(name: str) -> Any:
    # the JAX package defines these two here; the port keeps one default
    # executor per device, in ``device/__init__.py``
    if name in ("get_default_executor", "default_executor_snapshot"):
        import pathway_tpu_torch.device as _device

        return getattr(_device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

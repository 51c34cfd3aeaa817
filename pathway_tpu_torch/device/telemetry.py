"""Device-path observability: per-key FLOP counts, the cost accountant,
padding efficiency, CUDA memory stats and on-demand profiler traces.

Counterpart of ``pathway_tpu/device/telemetry.py``.  The reference reads
flops and bytes from XLA's ``cost_analysis()`` once per compile-cache key.
An eager PyTorch call has no compiled program to ask, so the port counts
once per cache key, on the key's first dispatch (or at ``warmup``):

* :func:`count_cost` runs the call under a ``TorchFunctionMode`` that
  adds 2·(output elements)·(contraction length) for every product it
  sees (``matmul``/``@``, ``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``linear``, two-operand ``einsum``) and both products of
  ``scaled_dot_product_attention``: the formulas of
  ``torch.utils.flop_counter``, applied at the torch-function level.
  ``FlopCounterMode`` itself is not used: a dispatch mode's first use
  in a process imports ``torch._dynamo``, seconds of host time that
  would land in the first counted dispatch of a serving process;
* a hand kernel reached outside PyTorch (the encoder-attention kernel is
  called through ``ctypes``) is invisible to any mode, so its wrapper
  reports its own FLOPs through :func:`note_flops`;
* a product-like function without a formula here (``torch._int_mm`` of
  the W8A8 path) marks the key ``analyzed = 0``: the accountant counts
  its dispatches as *uncosted*, never as zero FLOPs.

The counting dispatch is left out of the accountant's ledger (neither its
FLOPs nor its seconds), so the counting overhead never enters the achieved
rate.  Bytes are the compulsory traffic: every input tensor read once and
every output written once (``bytes_accessed = argument_bytes +
output_bytes``; ``temp_bytes`` is not measured and stays 0).

:func:`hbm_stats` reads ``torch.cuda.memory_stats`` (the caching
allocator's live and peak bytes); :func:`capture_trace` records a
``torch.profiler`` trace, one capture at a time; :func:`peak_flops` is the
roofline denominator (``PATHWAY_DEVICE_PEAK_FLOPS``, else the device-kind
table, else a CPU default that only exercises the arithmetic).
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from typing import Any, Callable

import torch

from pathway_tpu_torch.engine import metrics as _metrics
from pathway_tpu_torch.internals.config import env_float, env_str

__all__ = [
    "CostAccountant",
    "TraceBusy",
    "TraceUnavailable",
    "capture_trace",
    "count_cost",
    "extract_cost",
    "hbm_stats",
    "note_flops",
    "peak_flops",
    "render_device_snapshot",
]


# ---------------------------------------------------------------------------
# Roofline peak table
# ---------------------------------------------------------------------------

# Per-device-kind dense bf16 peak FLOP/s, matched case-insensitively as a
# substring of ``torch.cuda.get_device_name`` (NVIDIA's H100 SXM data
# sheet, without sparsity; the knob overrides it for another part).
PEAK_FLOPS_TABLE: tuple[tuple[str, float], ...] = (("h100", 989e12),)

# A CPU "utilization" only exercises the accounting arithmetic: a
# deliberately conservative per-core figure, as the JAX package's.
CPU_PEAK_FLOPS_PER_CORE = 8e9


def device_kind(device: torch.device | None = None) -> str:
    """``torch.cuda.get_device_name`` of ``device`` (of card 0 when None),
    or ``"cpu"``."""
    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    try:
        return torch.cuda.get_device_name(device)
    except Exception:  # noqa: BLE001 - accounting must never fail a run
        return "cpu"


def peak_flops(device: torch.device | None = None) -> tuple[float, str]:
    """``(peak FLOP/s, provenance)`` for the roofline denominator: the
    ``PATHWAY_DEVICE_PEAK_FLOPS`` knob, then the device-kind table, then
    the CPU default scaled by core count."""
    configured = env_float("PATHWAY_DEVICE_PEAK_FLOPS")
    if configured:
        return float(configured), "PATHWAY_DEVICE_PEAK_FLOPS"
    kind = device_kind(device).lower()
    for needle, value in PEAK_FLOPS_TABLE:
        if needle in kind:
            return value, kind
    cores = os.cpu_count() or 1
    return CPU_PEAK_FLOPS_PER_CORE * cores, f"cpu-default ({cores} cores)"


# ---------------------------------------------------------------------------
# FLOP counting, once per cache key
# ---------------------------------------------------------------------------

_scope = threading.local()

# name fragments of functions that do a product's worth of arithmetic; one
# without a formula below leaves its key uncounted
_PRODUCT_TAGS = ("mm", "conv", "attention", "matmul", "linear", "einsum")


def _contracted(a, out) -> float:
    """2·(output elements)·K for a product whose left operand ends in K."""
    return 2.0 * out.numel() * a.shape[-1]


def _einsum_flops(args, out) -> float | None:
    equation, operands = args[0], args[1:]
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    if len(operands) != 2 or "..." in equation:
        return None
    sizes: dict[str, int] = {}
    for spec, t in zip(equation.split("->")[0].split(","), operands):
        sizes.update(zip(spec.strip(), t.shape))
    n = 1
    for size in sizes.values():
        n *= size
    return 2.0 * n


def _sdpa_flops(args, kwargs, out) -> float:
    q = args[0] if args else kwargs["query"]
    k = args[1] if len(args) > 1 else kwargs["key"]
    v = args[2] if len(args) > 2 else kwargs["value"]
    rows = q.numel() // q.shape[-1]  # batch x heads x query rows
    return 2.0 * rows * k.shape[-2] * (q.shape[-1] + v.shape[-1])


def _product_flops(func, args, kwargs, out) -> float | None:
    """FLOPs of one call of a product function, or None when ``func`` is
    not one this table knows."""
    F = torch.nn.functional
    if func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.mm, torch.Tensor.mm,
                torch.bmm, torch.Tensor.bmm):
        return _contracted(args[0], out)
    if func is torch.Tensor.__rmatmul__:  # other @ self
        return _contracted(args[1], out)
    if func in (torch.addmm, torch.Tensor.addmm, torch.baddbmm, torch.Tensor.baddbmm, F.linear):
        return _contracted(args[1] if func is not F.linear else args[0], out)
    if func is torch.einsum:
        return _einsum_flops(args, out)
    if func is F.scaled_dot_product_attention:
        return _sdpa_flops(args, kwargs, out)
    return None


def note_flops(flops: float) -> None:
    """Add ``flops`` to the count running on this thread, if any: the hook
    for a kernel launched outside PyTorch (through ``ctypes``)."""
    counted = getattr(_scope, "counted", None)
    if counted is not None:
        counted[0] += float(flops)


def count_cost(fn: Callable[[], Any]) -> tuple[Any, dict[str, float]]:
    """Run ``fn()`` once under the FLOP count; returns ``(its result, the
    cost dict)``.  The cost's ``flops`` is the products' count plus what
    hand kernels reported through :func:`note_flops`; ``analyzed`` is 0.0
    when a product-like function without a formula ran.  Bytes are filled
    in by the caller, who knows the inputs."""
    from torch.overrides import TorchFunctionMode

    counted = [0.0]
    uncounted: list[str] = []

    class _Count(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            flops = _product_flops(func, args, kwargs, out)
            if flops is not None:
                counted[0] += flops
            elif any(tag in getattr(func, "__name__", "") for tag in _PRODUCT_TAGS):
                uncounted.append(func.__name__)
            return out

    prior = getattr(_scope, "counted", None)
    _scope.counted = counted
    try:
        with _Count():
            out = fn()
    finally:
        _scope.counted = prior
    cost = {
        "flops": counted[0],
        "bytes_accessed": 0.0,
        "argument_bytes": 0.0,
        "output_bytes": 0.0,
        "temp_bytes": 0.0,
        "analyzed": 0.0 if uncounted else 1.0,
    }
    return out, cost


def extract_cost(fn: Callable[[], Any]) -> dict[str, float]:
    """The cost dict of one call of ``fn`` (:func:`count_cost` without its
    result).  The JAX package reads this dict off a compiled XLA
    executable's cost analysis; an eager PyTorch call has none, so the port
    counts the call itself."""
    return count_cost(fn)[1]


# ---------------------------------------------------------------------------
# The accountant: per-executor cost/utilization/distribution ledger
# ---------------------------------------------------------------------------

MAX_DISTINCT_BATCH_SIZES = 512
BATCH_SIZE_EXPORT_TOP = 32


class CostAccountant:
    """Cumulative device cost ledger of one :class:`DeviceExecutor`,
    updated per dispatch under one small lock; honours the registry's
    kill switch."""

    def __init__(
        self,
        registry: "_metrics.MetricsRegistry | None" = None,
        device: torch.device | None = None,
    ):
        reg = registry if registry is not None else _metrics.get_registry()
        self._registry = reg
        self._m_flops = reg.counter(
            "device.flops.total", "counted FLOPs moved by dispatched device batches"
        )
        self._m_bytes = reg.counter(
            "device.bytes.accessed", "compulsory bytes of dispatched device batches"
        )
        self._lock = threading.Lock()
        self.flops_total = 0.0
        self.bytes_total = 0.0
        self.device_seconds = 0.0
        self.costed_dispatches = 0
        self.uncosted_dispatches = 0
        self.batch_sizes: dict[int, int] = {}
        self.batch_size_overflow = 0
        self.peak, self.peak_source = peak_flops(device)

    @property
    def enabled(self) -> bool:
        return self._registry.enabled

    def record_batch(self, n_rows: int) -> None:
        """One submitted ragged batch of ``n_rows`` real rows."""
        if not self._registry.enabled:
            return
        with self._lock:
            if n_rows in self.batch_sizes:
                self.batch_sizes[n_rows] += 1
            elif len(self.batch_sizes) < MAX_DISTINCT_BATCH_SIZES:
                self.batch_sizes[n_rows] = 1
            else:
                self.batch_size_overflow += 1

    def record_dispatch(self, cost: dict[str, float] | None, duration_s: float) -> None:
        """One fixed-shape device call of a key whose cost is ``cost``
        (None, or ``analyzed`` 0.0: uncosted, never zero FLOPs)."""
        if not self._registry.enabled:
            return
        if cost is None or not cost.get("analyzed", 1.0):
            with self._lock:
                self.uncosted_dispatches += 1
                self.device_seconds += duration_s
            return
        flops = cost.get("flops", 0.0)
        accessed = cost.get("bytes_accessed", 0.0)
        with self._lock:
            self.costed_dispatches += 1
            self.flops_total += flops
            self.bytes_total += accessed
            self.device_seconds += duration_s
        if flops:
            self._m_flops.inc(flops)
        if accessed:
            self._m_bytes.inc(accessed)

    def achieved_flops_per_s(self) -> float:
        with self._lock:
            if self.device_seconds <= 0.0:
                return 0.0
            return self.flops_total / self.device_seconds

    def utilization(self) -> float:
        if self.peak <= 0.0:
            return 0.0
        return self.achieved_flops_per_s() / self.peak

    def gauges(self) -> dict[str, float]:
        out = {
            "device.achieved.flops_per_s": self.achieved_flops_per_s(),
            "device.utilization": self.utilization(),
            "device.peak.flops_per_s": self.peak,
        }
        with self._lock:
            top = sorted(self.batch_sizes.items(), key=lambda kv: -kv[1])[:BATCH_SIZE_EXPORT_TOP]
        for size, count in top:
            out[f"device.batch.rows{{rows={size}}}"] = float(count)
        return out

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            sizes = dict(self.batch_sizes)
            out = {
                "flops_total": self.flops_total,
                "bytes_accessed_total": self.bytes_total,
                "device_seconds": self.device_seconds,
                "costed_dispatches": self.costed_dispatches,
                "uncosted_dispatches": self.uncosted_dispatches,
                "batch_size_overflow": self.batch_size_overflow,
            }
        out["achieved_flops_per_s"] = (
            out["flops_total"] / out["device_seconds"] if out["device_seconds"] > 0.0 else 0.0
        )
        out["peak_flops_per_s"] = self.peak
        out["peak_source"] = self.peak_source
        out["utilization"] = out["achieved_flops_per_s"] / self.peak if self.peak > 0.0 else 0.0
        out["batch_sizes"] = {str(k): v for k, v in sorted(sizes.items())}
        return out


# ---------------------------------------------------------------------------
# CUDA memory stats
# ---------------------------------------------------------------------------


def hbm_stats(device: torch.device | None = None) -> dict[str, float] | None:
    """The caching allocator's live and peak bytes of a CUDA ``device``
    (``torch.cuda.memory_stats``), or None on any other device, where the
    executor's tracked in-flight footprint stands in."""
    if device is None or torch.device(device).type != "cuda":
        return None
    try:
        stats = torch.cuda.memory_stats(device)
    except Exception:  # noqa: BLE001 - accounting must never fail a run
        return None
    if not stats:
        return None
    in_use = float(stats.get("allocated_bytes.all.current", 0) or 0)
    return {
        "bytes_in_use": in_use,
        "peak": float(stats.get("allocated_bytes.all.peak", in_use) or in_use),
    }


# ---------------------------------------------------------------------------
# On-demand trace capture
# ---------------------------------------------------------------------------


class TraceUnavailable(RuntimeError):
    """Trace capture cannot run here (no trace directory configured)."""


class TraceBusy(TraceUnavailable):
    """A capture is already in progress (one at a time: the profiler
    session is process-wide)."""


_MAX_TRACE_SECONDS = 120.0
_trace_lock = threading.Lock()
_trace_seq = 0
# A profiler session still open when the interpreter exits crashes it (a
# segfault in the profiler's teardown, reproduced by a capture that
# outlives its run): a capture ends early on ``_trace_stop``, which
# :func:`stop_trace` sets where the monitoring server closes and at exit.
_trace_stop = threading.Event()
_trace_closed = False
_trace_atexit = False


def capture_trace(seconds: float, trace_dir: str | None = None) -> str:
    """Record ``seconds`` of ``torch.profiler`` trace (CPU and, where a
    card is visible, CUDA activity) of this process into a fresh directory
    under ``trace_dir`` (default ``PATHWAY_DEVICE_TRACE_DIR``) and return
    its path; the trace is a Chrome trace file (``trace.json``).  One
    capture at a time (:class:`TraceBusy`); ``seconds`` is clamped to
    [0, 120], and :func:`stop_trace` ends a capture sooner; captures count
    under ``device.trace.captures``."""
    global _trace_atexit, _trace_seq
    base = trace_dir or env_str("PATHWAY_DEVICE_TRACE_DIR")
    if not base:
        raise TraceUnavailable(
            "no trace directory configured: set PATHWAY_DEVICE_TRACE_DIR "
            "(or pass an explicit directory)"
        )
    seconds = max(0.0, min(float(seconds), _MAX_TRACE_SECONDS))
    if not _trace_lock.acquire(blocking=False):
        raise TraceBusy("a trace capture is already running in this process")
    try:
        # a closing stop_trace sets _trace_closed before _trace_stop, so a
        # capture starting beside it sees the one or the other
        _trace_stop.clear()
        if _trace_closed:
            raise TraceUnavailable("the process is exiting")
        if not _trace_atexit:
            atexit.register(stop_trace, closing=True)
            _trace_atexit = True
        _trace_seq += 1
        path = os.path.join(
            base, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-pid{os.getpid()}-{_trace_seq:03d}"
        )
        os.makedirs(path, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            _trace_stop.wait(seconds)
        prof.export_chrome_trace(os.path.join(path, "trace.json"))
        _metrics.get_registry().counter(
            "device.trace.captures", "on-demand torch.profiler traces captured"
        ).inc()
        return path
    finally:
        _trace_lock.release()


def stop_trace(closing: bool = False) -> None:
    """End a running capture now and wait until its session has stopped
    and its trace is written; with ``closing`` (at exit) refuse any later
    capture too.  No-op when no capture runs."""
    global _trace_closed
    if closing:
        _trace_closed = True
    _trace_stop.set()
    if _trace_lock.acquire(timeout=60.0):  # the export of a long capture
        _trace_lock.release()


# ---------------------------------------------------------------------------
# Snapshot rendering
# ---------------------------------------------------------------------------


def format_utilization(util: float) -> str:
    """Percent for human-scale readings, scientific below 0.05%."""
    return f"{util:.2%}" if util >= 0.0005 else f"{util:.2e}"


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TiB"


def render_device_snapshot(snapshot: dict[str, Any]) -> str:
    """Human-readable device section of a ``device_snapshot()``; renders
    partial snapshots best-effort, never raising on a missing field."""
    cost = snapshot.get("cost") or {}
    lines = ["device:"]
    util = cost.get("utilization")
    if util is not None:
        lines.append(
            f"  utilization {format_utilization(util)} of "
            f"{cost.get('peak_flops_per_s', 0.0):.3g} FLOP/s peak "
            f"({cost.get('peak_source', '?')}) · achieved "
            f"{cost.get('achieved_flops_per_s', 0.0):.3g} FLOP/s"
        )
        lines.append(
            f"  flops {cost.get('flops_total', 0.0):.3g} · bytes accessed "
            f"{_fmt_bytes(cost.get('bytes_accessed_total', 0.0))} over "
            f"{cost.get('costed_dispatches', 0)} costed dispatch(es)"
            + (
                f" ({cost.get('uncosted_dispatches')} uncosted)"
                if cost.get("uncosted_dispatches")
                else ""
            )
        )
    padding = snapshot.get("padding") or {}
    if padding:
        lines.append(
            f"  padding waste {padding.get('fraction', 0.0):.2%} "
            f"({int(padding.get('pad_rows', 0))} pad / "
            f"{int(padding.get('real_rows', 0))} real rows)"
        )
    hbm = snapshot.get("hbm") or {}
    if hbm:
        lines.append(
            f"  hbm {_fmt_bytes(hbm.get('bytes_in_use', 0.0))} in use · "
            f"peak {_fmt_bytes(hbm.get('peak', 0.0))} "
            f"({hbm.get('source', '?')})"
        )
    queue = snapshot.get("queue") or {}
    if queue:
        lines.append(
            f"  queue {int(queue.get('backlog.device.queue', 0))} job(s) · "
            f"{_fmt_bytes(queue.get('backlog.device.bytes', 0.0))} in flight "
            f"· oldest {queue.get('backlog.device.age.s', 0.0):.2f} s"
        )
    callables = snapshot.get("callables") or {}
    for name in sorted(callables):
        st = callables[name] or {}
        lines.append(
            f"  {name}: {st.get('dispatches', 0)} dispatch(es), "
            f"{st.get('keys', 0)} cache key(s) "
            f"(cold {st.get('cold', 0)} / warmed {st.get('warmed', 0)})"
        )
    resilience = snapshot.get("resilience") or {}
    for name in sorted(resilience.get("callables") or {}):
        st = resilience["callables"].get(name) or {}
        breaker = st.get("breaker") or {}
        failures = st.get("failures") or {}
        interesting = (
            breaker.get("state") not in (None, "closed")
            or breaker.get("trips")
            or st.get("bucket_cap") is not None
            or st.get("fallback_batches")
            or failures
        )
        if not interesting:
            continue  # healthy callables say nothing, so failures stand out
        parts = [f"breaker {breaker.get('state', '?')}"]
        if breaker.get("trips"):
            parts.append(f"{breaker['trips']} trip(s)")
        if st.get("fallback_batches"):
            parts.append(f"{st['fallback_batches']} fallback batch(es)")
        if st.get("bucket_cap") is not None:
            parts.append(
                f"OOM-capped at bucket {st['bucket_cap']} ({st.get('oom_splits', 0)} split(s))"
            )
        if failures:
            parts.append("failures " + ", ".join(f"{k}={v}" for k, v in sorted(failures.items())))
        lines.append(f"  {name}: " + " · ".join(parts))
    quarantine = resilience.get("quarantine") or []
    if quarantine:
        lines.append(f"  quarantine: {len(quarantine)} poisoned batch(es)")
        for rec in quarantine[-3:]:
            lines.append(
                f"    {rec.get('callable', '?')}: {rec.get('rows', '?')} "
                f"row(s) — {rec.get('fallback_error', '?')}"
            )
    if len(lines) == 1:
        lines.append("  (no device activity recorded)")
    return "\n".join(lines)

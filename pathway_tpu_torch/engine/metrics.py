"""The process-wide metrics registry of the PyTorch port.

A slim copy of ``pathway_tpu/engine/metrics.py``: counters, gauges and
fixed-bucket histograms in labelled families, pull-time collectors, and
the flat ``{name[{labels}]: value}`` read the device layer's tests and
snapshots use, under the same metric names and labels as the JAX
package.  The Prometheus and OTLP exposition, exemplars and the declared
name table wait for the host-engine slice of the port.

``PATHWAY_METRICS_DISABLED`` (a registry-wide kill switch) is read from the
environment as the JAX package reads it.
"""

from __future__ import annotations

import os
import threading
import weakref
from bisect import bisect_left
from typing import Any, Callable, Iterable

DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0,
    500.0, 1000.0, 5000.0,
)

# millisecond-scale bounds (dispatch and job wall times)
MS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

# real-row fraction of each dispatched bucket, in (0, 1]
OCCUPANCY_BUCKETS = (
    0.0625, 0.125, 0.1875, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0,
)

# quantiles derived from every histogram's buckets at read time
QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


class _Enabled:
    """Shared mutable on/off flag — one attribute read per update."""

    __slots__ = ("on",)

    def __init__(self, on: bool):
        self.on = on


def _label_key(labels: dict[str, Any]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter child (one label set)."""

    __slots__ = ("_value", "_enabled")

    def __init__(self, enabled: _Enabled):
        self._value = 0.0
        self._enabled = enabled

    def inc(self, amount: float = 1.0) -> None:
        if self._enabled.on:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time gauge child (one label set)."""

    __slots__ = ("_value", "_enabled")

    def __init__(self, enabled: _Enabled):
        self._value = 0.0
        self._enabled = enabled

    def set(self, value: float) -> None:
        if self._enabled.on:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram child (one label set); ``observe`` touches
    one per-interval slot, reads are cumulative (``le`` semantics)."""

    __slots__ = ("_enabled", "_bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, enabled: _Enabled, bounds: tuple[float, ...]):
        self._enabled = enabled
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        if not self._enabled.on:
            return
        i = bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> tuple[tuple[float, ...], list[int], float, int]:
        """(bounds, per-interval counts, sum, count) — a consistent read."""
        with self._lock:
            return self._bounds, list(self._counts), self._sum, self._count

    def quantile(self, q: float) -> float | None:
        """The ``q``-quantile by linear interpolation within the holding
        bucket; the +Inf bucket clamps to the highest bound; ``None`` when
        empty."""
        bounds, counts, _total, n = self.snapshot()
        if n == 0 or not bounds:
            return None
        rank = q * n
        cum = 0
        lo = 0.0
        for bound, c in zip(bounds, counts):
            if c and cum + c >= rank:
                return lo + (rank - cum) / c * (bound - lo)
            cum += c
            lo = bound
        return float(bounds[-1])


class _Family:
    """One named metric family holding children keyed by label set."""

    __slots__ = ("name", "help", "kind", "buckets", "_children", "_enabled", "_lock")

    def __init__(
        self,
        name: str,
        help_: str,
        kind: str,
        enabled: _Enabled,
        buckets: tuple[float, ...] | None = None,
    ):
        self.name = name
        self.help = help_
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self.buckets = buckets
        self._children: dict[tuple, Any] = {}
        self._enabled = enabled
        self._lock = threading.Lock()

    def labels(self, **labels: Any):
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if self.kind == "counter":
                        child = Counter(self._enabled)
                    elif self.kind == "gauge":
                        child = Gauge(self._enabled)
                    else:
                        child = Histogram(self._enabled, self.buckets or DEFAULT_BUCKETS)
                    self._children[key] = child
        return child

    def items(self) -> list[tuple[tuple, Any]]:
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """Registry of metric families plus pull-time collectors (held weakly
    when they are bound methods, so a collector dies with its owner)."""

    def __init__(self, *, enabled: bool | None = None):
        if enabled is None:
            raw = os.environ.get("PATHWAY_METRICS_DISABLED", "").strip().lower()
            enabled = raw not in ("1", "true", "yes", "on")
        self._enabled = _Enabled(enabled)
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()
        self._collectors: dict[str, Any] = {}

    @property
    def enabled(self) -> bool:
        return self._enabled.on

    def _family(
        self,
        name: str,
        help_: str,
        kind: str,
        buckets: tuple[float, ...] | None = None,
    ) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = _Family(name, help_, kind, self._enabled, buckets)
                    self._families[name] = fam
        if fam.kind != kind:
            raise ValueError(f"metric {name!r} already registered as a {fam.kind}, not a {kind}")
        return fam

    def family(self, name: str) -> _Family | None:
        """Read-only lookup: ``None`` when nothing has touched the name."""
        return self._families.get(name)

    def counter(self, name: str, help_: str = "", **labels: Any) -> Counter:
        return self._family(name, help_, "counter").labels(**labels)

    def gauge(self, name: str, help_: str = "", **labels: Any) -> Gauge:
        return self._family(name, help_, "gauge").labels(**labels)

    def histogram(
        self,
        name: str,
        help_: str = "",
        buckets: Iterable[float] | None = None,
        **labels: Any,
    ) -> Histogram:
        bounds = tuple(buckets) if buckets is not None else None
        return self._family(name, help_, "histogram", bounds).labels(**labels)

    def register_collector(self, name: str, fn: Callable[[], dict[str, float] | None]) -> None:
        """Register a pull-time gauge supplier under a unique name
        (re-registering the name replaces it)."""
        try:
            ref: Any = weakref.WeakMethod(fn)  # bound method: weak to the owner
        except TypeError:
            ref = lambda f=fn: f  # noqa: E731 - plain function: held strongly
        with self._lock:
            self._collectors[name] = ref

    def collect(self) -> dict[str, float]:
        """Evaluate every live collector into one flat gauge dict."""
        with self._lock:
            refs = list(self._collectors.items())
        out: dict[str, float] = {}
        dead = []
        for name, ref in refs:
            fn = ref()
            if fn is None:
                dead.append((name, ref))
                continue
            try:
                out.update(fn() or {})
            except Exception:  # noqa: BLE001 - a supplier must never break a read
                continue
        if dead:
            with self._lock:
                for name, ref in dead:
                    if self._collectors.get(name) is ref:
                        self._collectors.pop(name, None)
        return out

    def scalar_metrics(self) -> dict[str, float]:
        """Flat ``{name[{labels}]: value}`` of counters and gauges, the
        histograms' derived ``.p50/.p95/.p99`` and every collector's
        output."""
        out: dict[str, float] = {}
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            if fam.kind == "histogram":
                continue
            for key, child in fam.items():
                out[_labelled(fam.name, key)] = child.value
        out.update(self.histogram_quantiles())
        out.update(self.collect())
        return out

    def histogram_quantiles(self) -> dict[str, float]:
        out: dict[str, float] = {}
        with self._lock:
            families = [f for f in self._families.values() if f.kind == "histogram"]
        for fam in families:
            for key, child in fam.items():
                for suffix, q in QUANTILES:
                    value = child.quantile(q)
                    if value is not None:
                        out[_labelled(f"{fam.name}.{suffix}", key)] = value
        return out


def _labelled(name: str, key: tuple[tuple[str, str], ...]) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


_registry: MetricsRegistry | None = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem of the port registers into."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry()
    return _registry


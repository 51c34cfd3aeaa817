"""Declared SLOs evaluated over the live metric families.

The serving path already *measures* everything (``serve.latency.ms``,
``generate.ttft.ms`` histograms, ``output.staleness.s`` freshness
gauges); this module adds the judgment layer: operators declare
objectives over those existing families and a cheap pull-time evaluator
turns them into error-budget arithmetic —

    ``slo.budget.remaining{slo=}``   fraction of the window's error
                                     budget left (1 untouched, 0
                                     exhausted, negative overspent)
    ``slo.burn.rate{slo=,window=}``  multi-window burn rates (1.0 =
                                     burning exactly the budget;
                                     sustained >1 exhausts it early)
    ``slo.violations``               rising-edge counter per SLO, each
                                     edge also lands a flight-recorder
                                     ``slo.violation`` event

Declaration grammar (``PATHWAY_SLOS``, semicolon-separated)::

    name: metric [pNN] < threshold[ms|s] over <duration>

    serve-latency: serve.latency.ms p95 < 250ms over 5m
    ttft:          generate.ttft.ms p95 < 500ms over 5m
    staleness:     output.staleness.s p95 < 5s over 5m

``pNN`` names the objective percentile — "95% of events must be good" —
so the error-budget fraction is ``1 - NN/100`` (default p95).  A *good*
event is an observation at or under the threshold.  Histogram-backed
SLOs count real observations from the family's cumulative buckets;
gauge-backed SLOs sample the gauge once per evaluation tick, so their
"events" are evaluation samples, not requests.

Burn-rate semantics (the multi-window SRE alerting shape): for each SLO
the evaluator keeps a ring of cumulative ``(ts, total, bad)`` snapshots
and reports ``bad_fraction / budget_fraction`` over a SHORT window
(``max(60s, window/5)`` — fast detection) and the declared LONG window
(sustained truth).  A violation edge fires only when BOTH exceed 1.0 —
short-only spikes are noise, long-only residue is history.

The evaluator is a registry collector (``slo.state``): it runs at scrape
time, throttled to at most once per second, so an idle process pays one
dict lookup per scrape and nothing between scrapes.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Any

from pathway_tpu_torch.engine import metrics as em

__all__ = [
    "SLO",
    "SLOEvaluator",
    "parse_slo",
    "parse_slos",
    "install",
    "get_evaluator",
    "default_declarations",
    "reset_for_tests",
]

# evaluator output cache lifetime: scrapes inside this interval reuse the
# previous evaluation (the "cheap collector" contract)
EVAL_INTERVAL_S = 1.0
# short-window floor: below this, one slow request dominates the burn
SHORT_WINDOW_FLOOR_S = 60.0

DEFAULT_DECLARATIONS = (
    "serve-latency: serve.latency.ms p95 < 250ms over 5m; "
    "ttft: generate.ttft.ms p95 < 500ms over 5m; "
    "staleness: output.staleness.s p95 < 5s over 5m"
)

# objectives over this family are serving-path staleness objectives:
# their input is clamped to the oldest outstanding admitted request age
# (the admission shedder's clamp) so an idle pipeline's frozen watermark
# never reads as burn — see _evaluate_one
STALENESS_METRIC = "output.staleness.s"


def _oldest_outstanding_age_s() -> float | None:
    """Age of the oldest admitted-but-unanswered serving request: 0.0
    when the serving path is live but idle, None when no admission
    controller exists in this process (a batch/non-serving pipeline —
    staleness then keeps its plain watermark meaning, unclamped)."""
    from pathway_tpu_torch.engine import serving as _serving

    c = _serving.controller_if_active()
    if c is None:
        return None
    try:
        return c.oldest_outstanding_age_s()
    except Exception:  # noqa: BLE001 - the evaluator must never break a scrape
        return None

_DECL_RE = re.compile(
    r"""
    ^\s*(?P<name>[A-Za-z0-9_.-]+)\s*:\s*
    (?P<metric>[A-Za-z0-9_.]+)
    (?:\s+p(?P<pct>\d{1,2}(?:\.\d+)?))?
    \s*<\s*
    (?P<threshold>\d+(?:\.\d+)?)\s*(?P<unit>ms|s)?
    \s+over\s+
    (?P<win>\d+(?:\.\d+)?)\s*(?P<winunit>s|m|h)
    \s*$
    """,
    re.VERBOSE,
)

_WINDOW_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0}


class SLO:
    """One declared objective: ``pNN`` of ``metric`` events at or under
    ``threshold`` (native metric unit) over ``window_s`` seconds."""

    __slots__ = ("name", "metric", "target", "threshold", "window_s")

    def __init__(
        self,
        name: str,
        metric: str,
        threshold: float,
        window_s: float,
        target: float = 0.95,
    ):
        if not 0.0 < target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1), got {target}")
        if window_s <= 0:
            raise ValueError(f"SLO window must be positive, got {window_s}")
        self.name = name
        self.metric = metric
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.target = float(target)

    @property
    def budget_fraction(self) -> float:
        """Tolerated bad-event fraction: ``1 - target``."""
        return 1.0 - self.target

    @property
    def short_window_s(self) -> float:
        return max(SHORT_WINDOW_FLOOR_S, self.window_s / 5.0)

    def describe(self) -> str:
        return (
            f"{self.metric} p{self.target * 100:g} < {self.threshold:g} "
            f"over {self.window_s:g}s"
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SLO({self.name!r}: {self.describe()})"


def _native_threshold(metric: str, value: float, unit: str | None) -> float:
    """Convert a declared threshold into the metric's native unit.

    Families carry their unit in the name suffix (``.ms`` / ``.s`` — the
    repo's convention), so ``< 250ms`` against a ``.s`` family and
    ``< 1.5s`` against a ``.ms`` family both mean what they say."""
    if unit is None:
        return value
    native_ms = metric.endswith(".ms")
    native_s = metric.endswith(".s")
    if unit == "ms":
        if native_s:
            return value / 1000.0
        return value
    # unit == "s"
    if native_ms:
        return value * 1000.0
    if native_s or not native_ms:
        return value
    return value


def parse_slo(text: str) -> SLO:
    """Parse one ``name: metric [pNN] < threshold[ms|s] over <dur>``
    declaration; raises ``ValueError`` with the offending text."""
    m = _DECL_RE.match(text)
    if m is None:
        raise ValueError(
            f"unparseable SLO declaration {text!r} (expected "
            f"'name: metric [pNN] < threshold[ms|s] over <Ns|Nm|Nh>')"
        )
    metric = m.group("metric")
    target = 0.95 if m.group("pct") is None else float(m.group("pct")) / 100.0
    threshold = _native_threshold(
        metric, float(m.group("threshold")), m.group("unit")
    )
    window_s = float(m.group("win")) * _WINDOW_UNITS[m.group("winunit")]
    return SLO(m.group("name"), metric, threshold, window_s, target=target)


def parse_slos(text: str) -> list[SLO]:
    """Parse a semicolon-separated declaration list; empty segments are
    skipped, duplicate names keep the LAST declaration (operator
    overrides of a default win)."""
    by_name: dict[str, SLO] = {}
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        slo = parse_slo(part)
        by_name[slo.name] = slo
    return list(by_name.values())


def default_declarations() -> str:
    """The effective declaration string: built-in defaults, with
    ``PATHWAY_SLOS`` appended so same-named operator declarations
    override the defaults (see :func:`parse_slos`)."""
    from pathway_tpu_torch.internals.config import env_str

    extra = env_str("PATHWAY_SLOS")
    if not extra:
        return DEFAULT_DECLARATIONS
    return f"{DEFAULT_DECLARATIONS}; {extra}"


class _SLOState:
    """Per-SLO cumulative counters + snapshot ring (the burn math)."""

    __slots__ = ("slo", "ring", "sample_total", "sample_bad", "violating")

    def __init__(self, slo: SLO):
        self.slo = slo
        # (ts, cumulative total events, cumulative bad events); pruned to
        # the long window + one baseline entry beyond it
        self.ring: deque[tuple[float, float, float]] = deque()
        # gauge-backed SLOs: cumulative evaluation-sample counts
        self.sample_total = 0.0
        self.sample_bad = 0.0
        self.violating = False  # for rising-edge detection


def _window_delta(
    ring: deque[tuple[float, float, float]], now: float, window_s: float
) -> tuple[float, float]:
    """(delta_total, delta_bad) between the newest snapshot and the
    newest snapshot at least ``window_s`` old (or the oldest held)."""
    if len(ring) < 2:
        return 0.0, 0.0
    newest = ring[-1]
    cutoff = now - window_s
    baseline = ring[0]
    for entry in ring:
        if entry[0] <= cutoff:
            baseline = entry
        else:
            break
    return newest[1] - baseline[1], newest[2] - baseline[2]


class SLOEvaluator:
    """Evaluates declared SLOs against the registry at scrape time."""

    def __init__(
        self,
        slos: list[SLO] | None = None,
        registry: em.MetricsRegistry | None = None,
    ):
        self._registry = registry or em.get_registry()
        self._states: dict[str, _SLOState] = {}
        self._lock = threading.Lock()
        self._last_eval = 0.0
        self._cached: dict[str, float] = {}
        self._in_eval = False  # reentrancy guard: we call collect() below
        for slo in slos if slos is not None else parse_slos(
            default_declarations()
        ):
            self._states[slo.name] = _SLOState(slo)

    @property
    def slos(self) -> list[SLO]:
        return [st.slo for st in self._states.values()]

    # -- sampling ----------------------------------------------------------
    def _histogram_counts(self, slo: SLO) -> tuple[float, float] | None:
        """Cumulative (total, bad) from a histogram family, summed over
        every label set; None when the family doesn't exist (yet)."""
        fam = self._registry.family(slo.metric)
        if fam is None or fam.kind != "histogram":
            return None
        total = 0.0
        bad = 0.0
        for _key, child in fam.items():
            bounds, counts, _sum, n = child.snapshot()
            total += n
            good = 0
            for bound, c in zip(bounds, counts):
                if bound <= slo.threshold:
                    good += c
                else:
                    break
            bad += n - good
        return total, bad

    def _gauge_value(self, slo: SLO, scalars: dict[str, float]) -> float | None:
        """Current value of a gauge-backed SLO metric: the worst (max)
        across label sets, from direct gauge families or collector
        output (``output.staleness.s{output=...}`` lives in the
        freshness collector, not a Gauge child)."""
        worst: float | None = None
        fam = self._registry.family(slo.metric)
        if fam is not None and fam.kind == "gauge":
            for _key, child in fam.items():
                v = child.value
                worst = v if worst is None else max(worst, v)
        prefix = slo.metric + "{"
        for key, v in scalars.items():
            if key == slo.metric or key.startswith(prefix):
                worst = v if worst is None else max(worst, v)
        return worst

    # -- evaluation --------------------------------------------------------
    def evaluate(self, now: float | None = None) -> dict[str, float]:
        """One evaluation pass → the ``slo.*`` gauge dict.  Safe to call
        directly (tests, ``/status``); the registered collector throttles
        it to :data:`EVAL_INTERVAL_S`."""
        if now is None:
            now = time.time()
        with self._lock:
            if self._in_eval:
                # collect() below re-enters us through the slo.state
                # collector; serve the previous answer instead of recursing
                return dict(self._cached)
            self._in_eval = True
        try:
            needs_scalars = any(
                (fam := self._registry.family(st.slo.metric)) is None
                or fam.kind != "histogram"
                for st in self._states.values()
            )
            scalars: dict[str, float] = {}
            if needs_scalars:
                # other collectors' output (freshness staleness gauges
                # live there); our own collector short-circuits via the
                # _in_eval guard above
                scalars = self._registry.collect()
            out: dict[str, float] = {}
            violations: list[tuple[SLO, float, float]] = []
            with self._lock:
                for st in self._states.values():
                    self._evaluate_one(st, now, scalars, out, violations)
                self._cached = out
                self._last_eval = now
        finally:
            with self._lock:
                self._in_eval = False
        for slo, burn_short, burn_long in violations:
            reg = self._registry
            reg.counter(
                "slo.violations",
                em.METRICS["slo.violations"][1],
                slo=slo.name,
            ).inc()
            from pathway_tpu_torch.engine import flight_recorder as _blackbox

            _blackbox.record(
                "slo.violation",
                slo=slo.name,
                objective=slo.describe(),
                burn_short=round(burn_short, 3),
                burn_long=round(burn_long, 3),
            )
        return dict(out)

    def _evaluate_one(
        self,
        st: _SLOState,
        now: float,
        scalars: dict[str, float],
        out: dict[str, float],
        violations: list,
    ) -> None:
        slo = st.slo
        counts = self._histogram_counts(slo)
        if counts is None:
            value = self._gauge_value(slo, scalars)
            if value is not None and slo.metric == STALENESS_METRIC:
                # an idle gap also grows output staleness (no input →
                # frozen watermark), and idleness is not an SLO breach:
                # when a serving admission controller is live the
                # staleness objective shares its clamp — it counts only
                # while an admitted request has actually been
                # outstanding that long (0 when the serving path is
                # idle), so sparse/idle pipelines stop burning budget
                # under the defaults.  Without a controller (batch or
                # non-serving pipelines) staleness keeps its plain
                # watermark meaning, unclamped.
                oldest = _oldest_outstanding_age_s()
                if oldest is not None:
                    value = min(value, oldest)
            if value is not None:
                st.sample_total += 1.0
                if value > slo.threshold:
                    st.sample_bad += 1.0
            counts = (st.sample_total, st.sample_bad)
        st.ring.append((now, counts[0], counts[1]))
        # prune: keep one baseline entry beyond the long window
        cutoff = now - slo.window_s
        while len(st.ring) > 2 and st.ring[1][0] <= cutoff:
            st.ring.popleft()
        budget = slo.budget_fraction
        burns: dict[str, float] = {}
        frac_long = 0.0
        for label, w in (
            (_fmt_window(slo.short_window_s), slo.short_window_s),
            (_fmt_window(slo.window_s), slo.window_s),
        ):
            total, bad = _window_delta(st.ring, now, w)
            frac = bad / total if total > 0 else 0.0
            burns[label] = frac / budget if budget > 0 else 0.0
            if w == slo.window_s:
                frac_long = frac
        for label, burn in burns.items():
            out[f"slo.burn.rate{{slo={slo.name},window={label}}}"] = round(
                burn, 4
            )
        remaining = 1.0 - (frac_long / budget if budget > 0 else 0.0)
        out[f"slo.budget.remaining{{slo={slo.name}}}"] = round(remaining, 4)
        burn_values = list(burns.values())
        violating = all(b > 1.0 for b in burn_values) and bool(burn_values)
        if violating and not st.violating:
            violations.append(
                (slo, burn_values[0], burn_values[-1])
            )
        st.violating = violating

    # -- collector + surfaces ----------------------------------------------
    def collect_state(self) -> dict[str, float]:
        """The ``slo.state`` registry collector: cached inside
        :data:`EVAL_INTERVAL_S`, one full evaluation otherwise."""
        now = time.time()
        with self._lock:
            if now - self._last_eval < EVAL_INTERVAL_S and self._cached:
                return dict(self._cached)
        return self.evaluate(now)

    def snapshot(self) -> dict[str, Any]:
        """Structured form for ``/status`` and flight-recorder dumps."""
        gauges = self.collect_state()
        slos = []
        with self._lock:
            states = list(self._states.values())
        for st in states:
            slo = st.slo
            prefix_burn = f"slo.burn.rate{{slo={slo.name},window="
            slos.append({
                "name": slo.name,
                "objective": slo.describe(),
                "metric": slo.metric,
                "threshold": slo.threshold,
                "target": slo.target,
                "window_s": slo.window_s,
                "budget_remaining": gauges.get(
                    f"slo.budget.remaining{{slo={slo.name}}}", 1.0
                ),
                "burn": {
                    key[len(prefix_burn):-1]: value
                    for key, value in gauges.items()
                    if key.startswith(prefix_burn)
                },
                "violating": st.violating,
            })
        return {"slos": slos}


def _fmt_window(seconds: float) -> str:
    if seconds % 3600 == 0 and seconds >= 3600:
        return f"{int(seconds // 3600)}h"
    if seconds % 60 == 0 and seconds >= 60:
        return f"{int(seconds // 60)}m"
    return f"{seconds:g}s"


# ---------------------------------------------------------------------------
# Process-wide evaluator
# ---------------------------------------------------------------------------

_evaluator: SLOEvaluator | None = None
_evaluator_lock = threading.Lock()


def get_evaluator() -> SLOEvaluator:
    global _evaluator
    if _evaluator is None:
        with _evaluator_lock:
            if _evaluator is None:
                _evaluator = SLOEvaluator()
    return _evaluator


def install(registry: em.MetricsRegistry | None = None) -> SLOEvaluator:
    """Register the process evaluator's collector (idempotent — the
    runner calls this per run; re-registering replaces the slot)."""
    evaluator = get_evaluator()
    reg = registry or em.get_registry()
    reg.register_collector("slo.state", evaluator.collect_state)
    return evaluator


def reset_for_tests() -> None:
    global _evaluator
    with _evaluator_lock:
        _evaluator = None

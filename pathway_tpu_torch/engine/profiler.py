"""Performance observability: per-operator epoch profiler + kernel accounting.

The port's copy of ``pathway_tpu/engine/profiler.py``.  Two surfaces:

* **Per-operator epoch profiler** (:class:`EpochProfiler`), as the JAX
  package has it.  The epoch loop stamps every operator step with a
  monotonic timer and row counters (``engine/dataflow.py:Scope.run_epoch``
  accumulates ``node.step_seconds`` / ``rows_in`` / ``rows_out``); the
  profiler turns those always-on counters into top-N attribution
  snapshots at a sampled cadence.  Snapshots export through the metrics
  registry (``profiler.operator.*``), ride flight-recorder dumps, land in
  a ``PATHWAY_PROFILE_OUTPUT`` JSON at run end, and render as a tree via
  ``python -m pathway_tpu_torch profile``.

* **Kernel accounting** (:func:`note_build`, :func:`note_load`), the
  port's counterpart of the JAX package's ``jax.monitoring`` listeners.
  The port has no jit: its compile events are the ``nvcc`` builds of its
  CUDA sources (``ops/_build.py``), counted with their wall seconds as
  ``device.kernel.builds`` / ``device.kernel.build.seconds``, and the
  loads of the built libraries (``device.kernel.loads``), always on and
  for the whole process: builds and loads happen once per source, mostly
  before any run starts.  A steady-state run builds nothing.  Under
  ``PATHWAY_PROFILE_TRANSFERS`` the executor's staging copies count as
  ``device.transfer.{h2d,d2h}.bytes`` (:func:`note_h2d`, :func:`note_d2h`).
"""

from __future__ import annotations

import json
import os
from typing import Any

from pathway_tpu_torch.engine import metrics as _metrics

__all__ = [
    "EpochProfiler",
    "note_build",
    "note_load",
    "install_jax_accounting",
    "install_transfer_accounting",
    "uninstall_transfer_accounting",
    "render_snapshot",
]

def _node_path(node: Any) -> str | None:
    """Columnar-vs-row attribution of one operator: which evaluator its
    batches actually ran through (``None`` = the operator has no columnar
    fast path, or saw no batches)."""
    vec = getattr(node, "vec_batches", 0)
    row = getattr(node, "row_batches", 0)
    if vec and row:
        return "mixed"
    if vec:
        return "columnar"
    if row:
        return "row"
    return None


def _bail_snapshot() -> list[dict[str, Any]]:
    """Top columnar-bail reasons (never raises — snapshots must always
    build, including from the crash path)."""
    try:
        from pathway_tpu_torch.internals import vector_compiler as vc

        return vc.bail_snapshot()
    except Exception:  # noqa: BLE001 - forensics must not fail the sample
        return []


class EpochProfiler:
    """Sampled top-N per-operator attribution over a running dataflow.

    One instance per run (the runner keeps it on ``RunResult.profiler``;
    the registry collector holds it weakly, so it dies with the result).
    ``on_epoch`` is the epoch-loop hook: a cheap cadence gate, then an
    attribute scan over the node arena — never a lock, never I/O.
    """

    def __init__(
        self,
        *,
        enabled: bool | None = None,
        sample_every: int | None = None,
        top_n: int | None = None,
        output_path: str | None = None,
    ):
        from pathway_tpu_torch.internals.config import env_bool, env_int, env_str

        self.enabled = (
            env_bool("PATHWAY_PROFILE") if enabled is None else bool(enabled)
        )
        every = (
            env_int("PATHWAY_PROFILE_SAMPLE_EVERY")
            if sample_every is None
            else sample_every
        )
        self.sample_every = max(1, int(every or 1))
        top = env_int("PATHWAY_PROFILE_TOP") if top_n is None else top_n
        self.top_n = max(1, int(top or 1))
        self.output_path = (
            env_str("PATHWAY_PROFILE_OUTPUT")
            if output_path is None
            else output_path
        )
        self.epochs_sampled = 0
        self._snapshot: dict[str, Any] | None = None

    # -- epoch-loop hook ---------------------------------------------------
    def on_epoch(self, scope: Any, epochs: int) -> None:
        """Called after every processed epoch; samples on cadence only."""
        if not self.enabled or epochs % self.sample_every:
            return
        self.sample(scope, epochs)

    def sample(self, scope: Any, epochs: int) -> dict[str, Any]:
        """Aggregate the node arena's cumulative counters into a top-N
        snapshot.  Reads plain attributes only — safe from the epoch
        thread and (for crash snapshots) from a signal handler."""
        ranked: list[Any] = sorted(
            scope.nodes, key=lambda n: n.step_seconds, reverse=True
        )
        total = sum(n.step_seconds for n in ranked)
        operators = [
            {
                "id": node.id,
                "name": getattr(node, "name", None) or "node",
                "seconds": node.step_seconds,
                "share": (node.step_seconds / total) if total else 0.0,
                "rows_in": node.rows_in,
                "rows_out": node.rows_out,
                "inputs": [inp.id for inp in node.inputs],
                # which execution path actually ran (engine/dataflow.py
                # vec_batches/row_batches): "columnar" / "row" / "mixed",
                # None for operators without a columnar fast path
                "path": _node_path(node),
            }
            for node in ranked[: self.top_n]
        ]
        self.epochs_sampled += 1
        self._snapshot = {
            "epochs": epochs,
            "operators_total": len(ranked),
            "total_step_seconds": total,
            "operators": operators,
            "bails": _bail_snapshot(),
        }
        return self._snapshot

    def crash_snapshot(self, scope: Any) -> dict[str, Any] | None:
        """A fresh snapshot for post-mortems, regardless of the sampling
        gate — the underlying timers are always on, so a crash dump can
        always say where the time went.  Never raises (forensics)."""
        try:
            return self.sample(scope, getattr(scope, "epochs_run", 0))
        except Exception:  # noqa: BLE001 - a dying process must still dump
            return self._snapshot

    @property
    def snapshot(self) -> dict[str, Any] | None:
        return self._snapshot

    # -- exports -----------------------------------------------------------
    def metrics_snapshot(self) -> dict[str, float]:
        """Registry collector: the latest snapshot's top-N as labeled
        gauges (bounded cardinality — only sampled leaders export)."""
        snap = self._snapshot
        if snap is None:
            return {}
        out: dict[str, float] = {
            "profiler.epochs.sampled": float(self.epochs_sampled),
        }
        for op in snap["operators"]:
            labels = f"id={op['id']},operator={op['name']}"
            out[f"profiler.operator.seconds{{{labels}}}"] = op["seconds"]
            out[f"profiler.operator.rows{{{labels}}}"] = float(op["rows_in"])
        return out

    def write_output(self) -> str | None:
        """Persist the final snapshot to ``PATHWAY_PROFILE_OUTPUT``;
        best-effort (a failed profile write must never fail the run)."""
        if not self.output_path or self._snapshot is None:
            return None
        try:
            tmp = f"{self.output_path}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self._snapshot, f, indent=2, sort_keys=True)
            os.replace(tmp, self.output_path)
            return self.output_path
        except OSError:
            return None


# ---------------------------------------------------------------------------
# Kernel accounting: nvcc builds, library loads, staging transfers
# ---------------------------------------------------------------------------

# (h2d, d2h) counters while transfer accounting is installed
_transfer_counters: tuple[Any, Any] | None = None


def note_build(source: str, seconds: float) -> None:
    """One finished ``nvcc`` build of ``csrc/<source>.cu`` (builds are rare:
    the per-source child is resolved on each call)."""
    reg = _metrics.get_registry()
    reg.counter(
        "device.kernel.builds", "nvcc builds of the port's CUDA sources", source=source
    ).inc()
    reg.counter(
        "device.kernel.build.seconds",
        "cumulative nvcc wall seconds of those builds",
        source=source,
    ).inc(seconds)


def note_load(source: str) -> None:
    """One library of ``csrc/<source>.cu`` loaded into this process."""
    _metrics.get_registry().counter(
        "device.kernel.loads", "kernel libraries loaded into this process", source=source
    ).inc()


def install_jax_accounting(force: bool = False) -> bool:
    """The JAX package's switch for its compile and cache-miss counters
    (``jax.compile.*``, ``jax.cache.miss``, opt-in under
    ``PATHWAY_PROFILE_JAX``).  Their counterparts here, the kernel-build
    counters ``device.kernel.builds``, ``device.kernel.build.seconds`` and
    ``device.kernel.loads`` (:func:`note_build`, :func:`note_load`), are
    always on, so there is nothing to install: accounting is active and
    this returns True, whatever ``force``."""
    return True


def install_transfer_accounting(force: bool = False) -> bool:
    """Count the executor's explicit host<->device staging bytes.

    Opt-in (``PATHWAY_PROFILE_TRANSFERS``), as in the JAX package; the
    executor's dispatch path reports each staged input and each copied-back
    output through :func:`note_h2d` / :func:`note_d2h`.  Copies made inside
    a model's own code never pass through it and stay out of scope.
    Reversible via :func:`uninstall_transfer_accounting`."""
    global _transfer_counters
    if _transfer_counters is not None:
        return True
    if not force:
        from pathway_tpu_torch.internals.config import env_bool

        if not env_bool("PATHWAY_PROFILE_TRANSFERS"):
            return False
    reg = _metrics.get_registry()
    _transfer_counters = (
        reg.counter("device.transfer.h2d.bytes", "host-to-device staging bytes"),
        reg.counter("device.transfer.d2h.bytes", "device-to-host copy-back bytes"),
    )
    return True


def uninstall_transfer_accounting() -> None:
    global _transfer_counters
    _transfer_counters = None


def note_h2d(nbytes: int) -> None:
    counters = _transfer_counters
    if counters is not None:
        counters[0].inc(nbytes)


def note_d2h(nbytes: int) -> None:
    counters = _transfer_counters
    if counters is not None:
        counters[1].inc(nbytes)


# ---------------------------------------------------------------------------
# Snapshot rendering (CLI / post-mortem)
# ---------------------------------------------------------------------------


def render_snapshot(snapshot: dict[str, Any], *, top: int | None = None) -> str:
    """Human-readable top-N attribution tree of one profiler snapshot.

    Operators print by cumulative step time with a share bar; each line
    names its input operators (``<- name#id``), so the hot chain reads as
    a tree even though the graph is a DAG.
    """
    # .get() everywhere: this renders foreign artifacts (hand-edited or
    # cross-version flight-recorder dumps) — a partial snapshot must
    # render best-effort, never traceback mid-blackbox-listing
    ops = snapshot.get("operators") or []
    if top is not None:
        ops = ops[:top]
    total = snapshot.get("total_step_seconds") or 0.0
    names = {op.get("id"): op.get("name", "op") for op in ops}
    lines = [
        f"profile: {snapshot.get('epochs', '?')} epochs · "
        f"{snapshot.get('operators_total', len(ops))} operators · "
        f"{total:.3f} s total operator time"
    ]
    if not ops:
        lines.append("  (no operator samples)")
        return "\n".join(lines)

    def tag(op) -> str:
        return f"{op.get('name', 'op')}#{op.get('id', '?')}"

    width = max(len(tag(op)) for op in ops)
    for op in ops:
        share = op.get("share") or 0.0
        bar = "#" * max(1, round(share * 20)) if total else ""
        inputs = ", ".join(
            f"{names.get(i, 'op')}#{i}" for i in op.get("inputs") or []
        )
        path = op.get("path")
        lines.append(
            f"  {tag(op):<{width}}  "
            f"{op.get('seconds') or 0.0:>9.3f} s  {share:>6.1%}  {bar:<20}  "
            f"rows {op.get('rows_in', '?')}->{op.get('rows_out', '?')}"
            + (f"  [{path}]" if path else "")
            + (f"  <- {inputs}" if inputs else "")
        )
    bails = snapshot.get("bails") or []
    if bails:
        lines.append("  columnar bails (fast path fell back to row-wise):")
        for b in bails:
            lines.append(
                f"    {b.get('op', '?')}/{b.get('reason', '?')}: "
                f"{b.get('count', '?')}"
            )
    return "\n".join(lines)

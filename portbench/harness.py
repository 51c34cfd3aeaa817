"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic and limits are files found by name
(``configs/``, ``traffic/``, ``limits/``); the traffic names its general
generator (``generators/``); each metric the cell reports is read by
``metrics/<metric>.py``.  The generator builds the program's system from
the seed, warms it up (set-up), measures ``--seconds``, and hands back
what the window saw and a check.  Once the window has closed and the
memory peak is read, the program's serving state is freed and the check
compares what the timed path produced with ``reference/``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import socket
import sys
import time
import traceback
from pathlib import Path

from portbench.probes import Probe

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pathway_tpu"}


def cache_env(root: Path) -> dict:
    """Build and kernel caches at fixed paths inside the checkout, and no
    tokenizer cache (the port then tokenizes with its hash tokenizer)."""
    cache = root / "_portbench_cache"
    return {
        "TRITON_CACHE_DIR": str(cache / "triton"),
        "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
        "TORCHINDUCTOR_CACHE_DIR": str(cache / "inductor"),
        "CUDA_CACHE_PATH": str(cache / "nv"),
        "HF_HOME": str(cache / "no-huggingface"),
        "USE_FLAX": "0",
        "USE_JAX": "0",
        "USE_TF": "0",
    }


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # what the module defines may look itself up by name
    spec.loader.exec_module(mod)
    return mod


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced (listed for it, or reported wherever the
    end-to-end metric they move is)."""
    own = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return own
    names = {m["name"] for m in own}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


class Cell:
    """One run of one cell: its files, seed and window, the probe the
    system is instrumented with, and the traced window."""

    def __init__(self, bench: dict, workload: dict, seed: int, seconds: float, trace: bool,
                 device=None, reference_device="cuda", control: bool = False, root: Path = HERE.parent):
        self.workload = workload
        self.config = load_json(root / _config_entry(bench, workload["config"])["file"])
        pdir = root / HERE.name
        self.traffic = load_json(pdir / "traffic" / f"{workload['traffic']}.json")
        self.limits = load_json(pdir / "limits" / f"{workload['name']}.json")
        store = self.config.get("store_config")
        self.store_config = load_json(root / _config_entry(bench, store)["file"]) if store else None
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.reference_device, self.control = device, reference_device, control
        self.probe = Probe(ranges=self.trace)
        self.window = self.trace_window = None
        self.trace_summary = None
        self.port = free_port()

    def measure(self) -> tuple[float, float]:
        """Open the window, wait it out, close it; returns it.  A traced run
        profiles its first ``trace_seconds`` (the traffic's, else the whole
        window): reading a long trace holds the interpreter for a time that
        grows with it, which a run's time limit has to hold."""
        traced = self.trace and self.device is None
        if traced:
            from portbench import devtrace

            profiler = devtrace.Window()
            profiler.start()
        t0 = time.perf_counter()
        self.window = (t0, t0 + self.seconds)
        if traced:
            t_trace = t0 + min(self.seconds, float(self.traffic.get("trace_seconds", self.seconds)))
            time.sleep(max(0.0, t_trace - time.perf_counter()))
            self.trace_window = (t0, time.perf_counter())
            ranges = [r[1:] for r in self.probe.of("range", self.trace_window)]
            self.trace_summary = profiler.stop(ranges, self.probe.foreign)
        time.sleep(max(0.0, self.window[1] - time.perf_counter()))
        return self.window


def _config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def run_cell(bench: dict, workload: dict, seed: int, seconds: float, trace: bool, *, device=None,
             reference_device="cuda", control: bool = False, root: Path = HERE.parent) -> dict:
    """Run the cell; returns the result line's fields (without ``device``'s
    card fields) and the compared numbers."""
    import torch

    cell = Cell(bench, workload, seed, seconds, trace, device, reference_device, control, root)
    for cfg in (cell.config, cell.store_config or {}):
        os.environ.update({k: str(v) for k, v in cfg.get("env", {}).items()})
    if control:
        for cfg in (cell.config, cell.store_config or {}):
            os.environ.update({k: str(v) for k, v in cfg.get("control_env", {}).items()})
    pdir = root / HERE.name
    generator = load_module(pdir / "generators" / f"{cell.traffic['generator']}.py",
                            f"portbench_generator_{cell.traffic['generator']}")
    on_card = device is None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    try:
        out = generator.run(cell)
    finally:
        cell.probe.close()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    generator.release(out)
    result = out["check"].run()
    numbers = result["numbers"]
    missing = sorted(set(cell.limits) - set(numbers))
    if missing:
        raise KeyError(f"limits/{workload['name']}.json names numbers the check does not give: {missing}")
    obs = {**out["obs"], "probe": cell.probe, "trace": cell.trace_summary, "config": cell.config,
           "store_config": cell.store_config, "traffic": cell.traffic}
    if trace and cell.trace_window is not None:
        # per-layer metrics read the traced part of the window
        obs.update(window=cell.trace_window, window_s=cell.trace_window[1] - cell.trace_window[0])
    metrics = {}
    for m in cell_metrics(bench, workload["name"], trace):
        value = load_module(pdir / "metrics" / f"{m['name']}.py", f"portbench_metric_{m['name']}").read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = [{"name": n, "value": float(numbers[n]), "limit": float(lim)} for n, lim in cell.limits.items()]
    return {
        "correct": all(c["value"] <= c["limit"] for c in checks),
        "attempted": int(result["attempted"]),
        "failed": int(result["failed"]),
        "metrics": metrics,
        "memory_peak_bytes": int(memory_peak),
        "trace": cell.trace_summary,
        "checks": checks,
        "diagnostics": out["obs"].get("diagnostics", {}),
        "readings": {n: float(v) for n, v in numbers.items() if n not in cell.limits},
    }


def forbidden_modules() -> list[str]:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = HERE.parent
    bench = load_json(root / "BENCHMARK.json")
    workload = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if workload is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    os.environ.update(cache_env(root))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"needs {workload['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        res = run_cell(bench, workload, args.seed, args.seconds, bool(args.trace))
    except Exception:  # noqa: BLE001 - the run is reported as failed, with its traceback
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {bad}: the benchmark runs without JAX and the JAX package", file=sys.stderr)
        return 3
    return emit(res, workload, bool(args.trace))


def emit(res: dict, workload: dict, trace: bool) -> int:
    import torch

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": workload["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if trace and res["trace"]:
        device["busy_s"] = res["trace"]["busy_s"]
        device["window_s"] = res["trace"]["window_s"]
        line["breakdown"] = {"device_ops": res["trace"]["device_ops"], "idle_gaps": res["trace"]["idle_gaps"]}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in res["checks"]}
    print(f"card: {torch.cuda.get_device_name(0)}, power limit {power_limit()}", file=sys.stderr)
    print(f"window: {json.dumps(res.get('diagnostics', {}))}", file=sys.stderr)
    print(f"readings not compared: {json.dumps(res.get('readings', {}))}", file=sys.stderr)
    if res["trace"]:
        tr = res["trace"]
        print(f"trace: kernel s by range {json.dumps(tr['range_kernel_s'])}, tied to no range "
              f"{tr['ambiguous_kernel_s']}, threads with ranges {tr['range_threads']}, launches {tr['launches']}",
              file=sys.stderr)
    for c in res["checks"]:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"

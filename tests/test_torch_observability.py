"""The port's observability surface against the JAX package's.

* Exposition: the same registry operations give byte-equal Prometheus
  text (``# EOF`` included) and OTLP/HTTP+JSON bodies in both packages,
  apart from the declared renames: the OTLP scope is the package's name,
  and the JAX package's jit accounting (``jax.compile.*``,
  ``jax.cache.miss``, ``jax.transfer.*``) is the port's kernel-build and
  transfer accounting (``device.kernel.*``, ``device.transfer.*``).
* ``/status`` has the same keys in both packages for one program, and
  ``/trace`` keeps its 400/409/503 contract (200 with a parseable Chrome
  trace from ``torch.profiler`` on the CPU); captures in a live run, and
  one cut short by its end or by the process's exit, leave it running.
* A CPU run of ``chip_smoke.py``'s ``[observability]`` program serves every
  family of ``chip_smoke.OBS_FAMILIES`` mid-run: the golden list the card's
  gate holds each scrape to.
* The ``profile``, ``blackbox``, ``top`` and ``requests`` commands render
  the same artifacts and endpoint to the same text as the JAX package's.
* The kernel-build counters move under a stand-in for ``nvcc`` (this
  machine has none).
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import json
import os
import re
import stat
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu import cli as jcli
from pathway_tpu.engine import http_server as jhttp
from pathway_tpu.engine import metrics as jmetrics
from pathway_tpu.engine import telemetry as jtelemetry
from pathway_tpu.engine.probes import OperatorStats as JOperatorStats
from pathway_tpu.engine.probes import ProberStats as JProberStats
from pathway_tpu_torch import cli as tcli
from pathway_tpu_torch.device import telemetry as tdevtel
from pathway_tpu_torch.engine import flight_recorder as tfr
from pathway_tpu_torch.engine import http_server as thttp
from pathway_tpu_torch.engine import metrics as tmetrics
from pathway_tpu_torch.engine import profiler as tprofiler
from pathway_tpu_torch.engine import telemetry as ttelemetry
from pathway_tpu_torch.engine.probes import OperatorStats as TOperatorStats
from pathway_tpu_torch.engine.probes import ProberStats as TProberStats
from tests import torch_cluster_programs as progs

RENAMES = {
    "jax.compile.count": "device.kernel.builds",
    "jax.compile.seconds": "device.kernel.build.seconds",
    "jax.cache.miss": "device.kernel.loads",
    "jax.transfer.h2d.bytes": "device.transfer.h2d.bytes",
    "jax.transfer.d2h.bytes": "device.transfer.d2h.bytes",
}
PORT_ONLY = {"generate.prompt.truncated": "counter"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    tpw.G.clear()
    yield
    tpw.G.clear()


class _FixedClock:
    """``time`` with ``time()`` pinned, for exemplar and sample stamps."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return 1_700_000_000.25


def fill(metrics, reg) -> None:
    """The same registry operations in either package."""
    reg.counter("comm.bytes.sent", "bytes written to peers", peer="1").inc(1234)
    reg.counter("comm.bytes.sent", "bytes written to peers", peer="2").inc(5)
    reg.gauge("output.staleness.s", "staleness", output='sink "a"\\b').set(1.5)
    reg.gauge("autoscaler.target.workers", "target").set(2)
    h = reg.histogram("epoch.duration.ms", "epoch ms", buckets=metrics.MS_BUCKETS)
    for v in (0.3, 2.0, 2.5, 40.0, 700.0):
        h.observe(v)
    s = reg.histogram("serve.latency.ms", "latency", buckets=(50, 100, 250), route="/v1/q")
    s.observe(20.0, trace_id="ab" * 16)
    s.observe(300.0, trace_id="cd" * 16)
    reg.register_collector("test.collector", lambda: {"backlog.ingest.rows{source=src}": 3.0,
                                                      "freshness.mesh.staleness.s": 0.25})


@pytest.fixture
def registries(monkeypatch):
    monkeypatch.setattr(jmetrics, "_time", _FixedClock())
    monkeypatch.setattr(tmetrics, "_time", _FixedClock())
    regs = {}
    for name, metrics in (("jax", jmetrics), ("torch", tmetrics)):
        reg = metrics.MetricsRegistry(enabled=True)
        fill(metrics, reg)
        regs[name] = reg
    return regs


def prober_stats(stats_cls, op_cls):
    return stats_cls(epochs=7, input_stats=op_cls(name="input", time=12, lag_ms=3.5, rows_out=40),
                     output_stats=op_cls(name="output", time=12, lag_ms=4.0, rows_in=38),
                     operator_stats={3: op_cls(name="groupby", rows_in=40, rows_out=9)}, row_counts={3: 9})


@pytest.mark.parametrize("run_id", [None, "run-7"])
def test_prometheus_exposition_is_byte_equal(registries, run_id):
    j, t = registries["jax"], registries["torch"]
    assert t.render_prometheus() == j.render_prometheus()
    body = thttp.render_prometheus(prober_stats(TProberStats, TOperatorStats), run_id, registry=t)
    assert body == jhttp.render_prometheus(prober_stats(JProberStats, JOperatorStats), run_id, registry=j)
    assert body.endswith("# EOF\n") and 'pathway_serve_latency_ms_bucket{route="/v1/q",' in body
    assert "# {trace_id=" in body  # the exemplar of a traced bucket
    assert t.scalar_metrics() == j.scalar_metrics()
    assert t.histogram_quantiles() == j.histogram_quantiles()
    assert "epoch.duration.ms.p95" in t.scalar_metrics()


def test_otlp_bodies_are_byte_equal_but_for_the_scope_name(registries):
    j, t = registries["jax"], registries["torch"]
    resource = {"service.name": "pathway", "run.id": "r1"}
    bodies = []
    for tel, reg in ((jtelemetry, j), (ttelemetry, t)):
        payload = {"resource": resource, "ts": 1_700_000_000.0,
                   "metrics": dict(reg.scalar_metrics(), **{"process.cpu.utime": 1.25}),
                   "histograms": reg.histogram_points()}
        span = {"name": "pathway.epoch", "start": 1_700_000_000.0, "duration_s": 0.004,
                "attributes": {"epoch": 12, "index": 16}, "trace_id": "ab" * 16, "span_id": "cd" * 8,
                "parent_span_id": ""}
        bodies.append((json.dumps(tel._otlp_metrics(payload)), json.dumps(tel._otlp_traces(
            {"resource": resource, "span": span}))))
    for jb, tb in zip(*bodies):
        assert tb == jb.replace('"name": "pathway_tpu"', '"name": "pathway_tpu_torch"')
        assert '"name": "pathway_tpu_torch"' in tb


def test_the_declared_name_table_is_the_jax_one_with_the_renames():
    expected = {RENAMES.get(name, name): kind for name, (kind, _doc) in jmetrics.METRICS.items()}
    assert {name: kind for name, (kind, _doc) in tmetrics.METRICS.items()} == dict(expected, **PORT_ONLY)
    assert not [name for name in tmetrics.METRICS if name.startswith("jax.")]
    # every family the port's source registers is declared, whichever
    # test or run happens to reach it
    root = os.path.dirname(tpw.__file__)
    pattern = re.compile(r'\.(?:counter|gauge|histogram)\(\s*"([a-z0-9_.]+)"')
    registered = {name for folder, _dirs, files in os.walk(root) for f in files if f.endswith(".py")
                  for name in pattern.findall(open(os.path.join(folder, f)).read())}
    assert registered and not sorted(registered - set(tmetrics.METRICS))


def test_the_port_emits_only_declared_names_after_a_monitored_run(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_PROFILE", "1")
    observability_run(tmp_path, scrape=False)
    reg = tmetrics.get_registry()
    families = set(reg._families)
    undeclared = sorted(f for f in families if f not in tmetrics.METRICS and not f.startswith("test."))
    assert not undeclared
    emitted = {tmetrics.split_labeled_name(k)[0] for k in reg.scalar_metrics()}
    assert not [name for name in emitted if name.startswith("jax.")]


# ---------------------------------------------------------------------------
# /status and /trace
# ---------------------------------------------------------------------------


def scrape_once_delivered(port: int, got: dict, go: threading.Event, metrics: bool = False) -> threading.Thread:
    """A thread that polls ``/status`` until an output was delivered, keeps
    it (and one ``/metrics`` body) in ``got``, then sets ``go``."""

    def scrape():
        base = f"http://127.0.0.1:{port}"
        for _ in range(600):
            try:
                status = json.loads(urllib.request.urlopen(base + "/status", timeout=2).read())
                if status["output"]["rows_in"] and status.get("freshness"):
                    if metrics:
                        got["metrics"] = urllib.request.urlopen(base + "/metrics", timeout=2).read()
                    got["status"] = status
                    break
            except OSError:
                pass
            time.sleep(0.05)
        go.set()

    return threading.Thread(target=scrape, daemon=True)


def status_of_one_program(pw, port: int) -> dict:
    """``/status`` mid-run of a two-commit subject program."""
    got, go = {}, threading.Event()

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            self.next(k=1, v=2)
            self.commit()
            go.wait(30)
            self.next(k=2, v=3)
            self.commit()

    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(k=int, v=int), name="feed")
    t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v))._subscribe_raw(lambda *a: None,
                                                                                       name="sums")
    scrape_once_delivered(port, got, go).start()
    try:
        with pw.local_pathway_config(monitoring_http_port=port):
            pw.run(with_http_server=True, monitoring_level=pw.MonitoringLevel.NONE)
    finally:
        pw.G.clear()
    return got["status"]


STATUS_PROGRAM = """
import json
import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from tests.test_torch_observability import status_of_one_program
from tests.torch_cluster_programs import free_port_base
print(json.dumps({name: status_of_one_program(pw, free_port_base(1)) for name, pw in (("jax", jpw), ("torch", tpw))}))
"""


def test_status_has_the_same_keys_in_both_packages():
    # a fresh interpreter: each package's registry holds this program's
    # series only, not those of the tests that ran before in this worker
    proc = subprocess.run([sys.executable, "-c", STATUS_PROGRAM], cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    statuses = json.loads(proc.stdout.strip().splitlines()[-1])
    j, t = statuses["jax"], statuses["torch"]
    assert sorted(t) == sorted(j)
    for section in ("input", "output", "epoch", "requests", "slo", "backlog", "freshness", "operators"):
        assert sorted(t[section]) == sorted(j[section]), section
    assert len([k for k in t["freshness"] if "output=sums" in k]) == 4
    assert "output.staleness.s{output=sums}" in t["freshness"]
    assert "backlog.connector.queue{source=feed}" in t["backlog"]


def test_trace_keeps_its_contract(tmp_path, monkeypatch):
    monkeypatch.delenv("PATHWAY_DEVICE_TRACE_DIR", raising=False)
    for http in (jhttp, thttp):
        body, code = http._handle_trace("/trace?seconds=abc")
        assert code == 400 and "bad seconds" in json.loads(body)["error"]
        body, code = http._handle_trace("/trace?seconds=0.1")
        assert code == 503 and "PATHWAY_DEVICE_TRACE_DIR" in json.loads(body)["error"]
    monkeypatch.setenv("PATHWAY_DEVICE_TRACE_DIR", str(tmp_path))
    assert tdevtel._trace_lock.acquire(blocking=False)
    try:
        body, code = thttp._handle_trace("/trace?seconds=0.1")
        assert code == 409 and "already running" in json.loads(body)["error"]
    finally:
        tdevtel._trace_lock.release()
    body, code = thttp._handle_trace("/trace?seconds=0.05")
    assert code == 200
    with open(os.path.join(json.loads(body)["trace_dir"], "trace.json")) as f:
        assert "traceEvents" in json.load(f)


TRACE_STRESS = """
import glob, json, os, socket, sys, threading, time, urllib.request
import torch
import pathway_tpu_torch as pw
from pathway_tpu_torch.device import telemetry
from pathway_tpu_torch.engine import metrics

w = torch.randn(32, 32)
done = threading.Event()

class Feed(pw.io.python.ConnectorSubject):
    def run(self):
        i = 0
        while not done.is_set():
            self.next(k=i % 5, v=i)
            i += 1
            self.commit()
            time.sleep(0.002)

@pw.udf
def project(v: int) -> float:
    return float(torch.tanh(torch.full((4, 32), float(v)) @ w).sum())

s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]; s.close()
t = pw.io.python.read(Feed(), schema=pw.schema_from_types(k=int, v=int))
t.select(pw.this.k, p=project(pw.this.v)).groupby(pw.this.k).reduce(
    pw.this.k, n=pw.reducers.count())._subscribe_raw(lambda *a: None, name="o")
codes = []

def get(path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}" + path, timeout=60) as r:
        return r.status

def client():
    for _ in range(600):
        try:
            get("/status"); break
        except OSError:
            time.sleep(0.05)
    codes.extend(get("/trace?seconds=0.05") for _ in range(int(sys.argv[1])))
    # one capture asked for far past the run's end, which comes now
    threading.Thread(target=lambda: codes.append(get("/trace?seconds=60")), daemon=True).start()
    time.sleep(0.3)
    done.set()

threading.Thread(target=client, daemon=True).start()
started = time.monotonic()
with pw.local_pathway_config(monitoring_http_port=port):
    pw.run(with_http_server=True, monitoring_level=pw.MonitoringLevel.NONE)
captures = metrics.get_registry().scalar_metrics()["device.trace.captures"]
# a capture on a daemon thread still running when the interpreter exits
threading.Thread(target=telemetry.capture_trace, args=(60,), daemon=True).start()
time.sleep(0.3)
print(json.dumps({"codes": codes, "captures": captures, "run_s": time.monotonic() - started}))
"""


def test_trace_captures_during_a_live_run_and_past_its_end(tmp_path):
    """Captures in a row during a live run, then one that outlives the run
    (the run's end cuts it short) and one still running when the process
    exits (cut short at exit).  A profiler session left open at exit
    crashed the process in its teardown (a segfault): the exit code is 0
    and all ten traces are written."""
    env = dict(os.environ, PATHWAY_DEVICE_TRACE_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", TRACE_STRESS, "8"], env=env, capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["codes"] == [200] * 9 and got["captures"] == 9.0 and got["run_s"] < 50, got
    traces = sorted(tmp_path.glob("trace-*/trace.json"))
    assert len(traces) == 10
    for path in traces:
        assert "traceEvents" in json.loads(path.read_text())


# ---------------------------------------------------------------------------
# chip_smoke's [observability] program on the CPU: the golden families
# ---------------------------------------------------------------------------


def observability_run(tmp_path, *, scrape: bool = True) -> dict:
    """``chip_smoke.observability_program`` over 256 texts in commits of
    32, its UDF a matmul through the CPU executor's batcher, with the
    server on and /metrics scraped once an output was delivered."""
    import chip_smoke
    from pathway_tpu_torch.device import BucketPolicy, get_default_executor
    from pathway_tpu_torch.utils.batching import AsyncMicroBatcher

    got, go = {}, threading.Event()
    ex = get_default_executor("cpu")
    weights = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 8)).astype(np.float32))
    if not ex.registered("observability:proj"):
        ex.register("observability:proj", lambda x: x @ weights, policy=BucketPolicy(max_bucket=64))

    batches = []

    def process(texts):
        batches.append(len(texts))
        if scrape and len(batches) > 1:
            go.wait(30)  # the second epoch's batch waits for the scrape
        feats = np.stack([np.frombuffer(t.encode()[:32].ljust(32, b" "), np.uint8)[:8] for t in texts])
        return list(np.asarray(ex.run_batch("observability:proj", (feats.astype(np.float32) / 255.0,))))

    batcher = AsyncMicroBatcher(process, max_batch_size=32, executor=ex, name="observability:embedder")
    texts = [f"text {i} of the observability program" for i in range(256)]
    sources = np.arange(256) % chip_smoke.OBS_SOURCES
    query = np.ones(8, np.float32) / np.sqrt(8.0)
    port = progs.free_port_base(1)
    commit = chip_smoke.OBS_COMMIT

    chip_smoke.OBS_COMMIT = 32
    try:
        _tables, captured = chip_smoke.observability_program(
            tpw, texts, sources, chip_smoke.embedding_udf(tpw, batcher.submit), query)
        if scrape:
            scrape_once_delivered(port, got, go, metrics=True).start()
        with tpw.local_pathway_config(monitoring_http_port=port):
            tpw.run(with_http_server=scrape, monitoring_level=tpw.MonitoringLevel.NONE)
    finally:
        chip_smoke.OBS_COMMIT = commit
        tpw.G.clear()
    got["captured"] = captured
    return got


def test_a_cpu_run_serves_every_golden_family(tmp_path, monkeypatch):
    import chip_smoke

    monkeypatch.setenv("PATHWAY_PROFILE", "1")
    monkeypatch.setenv("PATHWAY_PROFILE_SAMPLE_EVERY", "1")
    got = observability_run(tmp_path)
    body = got["metrics"].decode()
    assert body.endswith("# EOF\n")
    missing = [f for f in chip_smoke.OBS_FAMILIES if f"# TYPE {f} " not in body]
    assert not missing, missing
    assert any(v > 0 for k, v in chip_smoke.prom_samples(body, "pathway_freshness_e2e_ms_count").items()
               if "output=" in k)
    assert len(chip_smoke.final_rows(got["captured"]["docs"])) == 256


# ---------------------------------------------------------------------------
# CLI renders against the JAX package's
# ---------------------------------------------------------------------------


def port_cli(argv) -> tuple[int, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = tcli.main(argv)
    return code, out.getvalue() + err.getvalue()


def jax_cli(argv) -> tuple[int, str]:
    from click.testing import CliRunner

    result = CliRunner().invoke(jcli.cli, argv)
    text = result.output
    for jax_name, port_name in CLI_RENAMES.items():
        text = text.replace(jax_name, port_name)
    return result.exit_code, text


# the only differences the renders may show: the package's name
CLI_RENAMES = {"[pathway_tpu]": "[pathway_tpu_torch]", "pathway_tpu top ·": "pathway_tpu_torch top ·"}


def write_dump(root, **sections) -> str:
    rec = tfr.FlightRecorder()
    rec.configure(root=str(root), worker=0, run_id="r-cli", attempt=1)
    for section, value in sections.items():
        getattr(rec, f"set_{section}_supplier")(lambda value=value: value)
    rec.record("epoch.start", time=2)
    rec.record("commit", generation=4, frontier=6)
    return rec.dump("worker crashed: boom")


TRACE = {
    "trace_id": "ab" * 16, "route": "/v1/retrieve", "status": 200, "duration_ms": 12.5,
    "started_at": 1_700_000_000.0, "spans": [
        {"name": "serve.admission", "start": 1_700_000_000.0, "duration_s": 0.001, "span_id": "01" * 8,
         "parent_span_id": "00" * 8, "attributes": {}},
        {"name": "serve.batch", "start": 1_700_000_000.002, "duration_s": 0.004, "span_id": "02" * 8,
         "parent_span_id": "00" * 8, "attributes": {"batch_size": 3}},
        {"name": "serve.request", "start": 1_700_000_000.0, "duration_s": 0.0125, "span_id": "00" * 8,
         "parent_span_id": "", "attributes": {"status": 200}}]}


def test_blackbox_profile_and_requests_render_dumps_alike(tmp_path):
    snapshot = {"epochs": 9, "operators_total": 2, "total_step_seconds": 1.0, "bails": [],
                "operators": [{"id": 1, "name": "groupby", "seconds": 0.75, "share": 0.75, "rows_in": 9,
                               "rows_out": 3, "inputs": [0], "path": "row"},
                              {"id": 0, "name": "input", "seconds": 0.25, "share": 0.25, "rows_in": 9,
                               "rows_out": 9, "inputs": []}]}
    freshness = {"epochs_tracked": 9, "outputs": {"sink": {"staleness_s": 1.5, "delivered_ago_s": 0.5}},
                 "backlog": {"backlog.connector.queue{source=src}": 4.0}}
    autoscaler = {"target_workers": 2, "budget_left": 1, "handoff_state": None,
                  "decisions": [{"action": "grow", "from": 1, "to": 2, "at": 1.0}]}
    serving = {"inflight": 3, "queue_depth": 1, "limits": {"inflight": 64, "queue": 256}, "degraded": True}
    dump = write_dump(tmp_path / "root", profile=snapshot, freshness=freshness, autoscaler=autoscaler,
                      serving=serving, tracing={"slowest": [TRACE], "recent": [TRACE]})
    root = str(tmp_path / "root")
    (tmp_path / "empty").mkdir()
    for argv in (["blackbox", root], ["blackbox", "--tail", "1", root], ["blackbox", "--json", root],
                 ["blackbox", str(tmp_path / "empty")], ["profile", root], ["profile", dump],
                 ["profile", "--json", dump], ["profile", str(tmp_path / "empty")],
                 ["requests", dump], ["requests", "--recent", "--json", dump], ["requests", "-n", "0", dump]):
        assert port_cli(argv) == jax_cli(argv), argv
    code, text = port_cli(["blackbox", root])
    assert code == 0 and "groupby#1" in text and "output sink: staleness 1.5 s" in text
    assert "autoscaler: target 2 worker(s)" in text and "serving: 3/64 in flight" in text


def test_top_renders_the_same_endpoint_alike():
    reg = tmetrics.MetricsRegistry(enabled=True)
    reg.gauge("output.staleness.s", "", output="sink").set(1.5)
    reg.gauge("backlog.connector.queue", "", source="src").set(7)
    reg.counter("device.dispatch.batches", "").inc(12)
    reg.gauge("device.utilization", "").set(0.25)
    h = reg.histogram("freshness.e2e.ms", "", buckets=(1, 10, 100), output="sink")
    for v in (2.0, 3.0, 50.0):
        h.observe(v)
    server = thttp.MonitoringServer(port=0, run_id="r-top", registry=reg).start()
    try:
        server.update(prober_stats(TProberStats, TOperatorStats))
        url = f"http://127.0.0.1:{server._httpd.server_address[1]}/status"
        for argv in (["top", "--once", "--url", url], ["top", "--once", "--json", "--url", url],
                     ["top", "--once", "--url", "http://127.0.0.1:1/status"]):
            got, want = port_cli(argv), jax_cli(argv)
            assert got == want, argv
        code, text = port_cli(["top", "--once", "--url", url])
        assert code == 0 and "r-top" in text and "staleness" in text and "device" in text
    finally:
        server.close()


# ---------------------------------------------------------------------------
# Kernel-build and transfer counters
# ---------------------------------------------------------------------------


def test_kernel_build_counters_move_under_a_stand_in_builder(tmp_path, monkeypatch):
    from pathway_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys, time\ntime.sleep(0.05)\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\nopen(out, 'wb').write(b'lib')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("loaded", path))
    reg = tmetrics.get_registry()

    def counters():
        snap = reg.scalar_metrics()
        return {(base, labels.get("source")): v for k, v in snap.items()
                for base, labels in [tmetrics.split_labeled_name(k)] if base.startswith("device.kernel.")}

    before = counters()
    names = _build.sources()
    assert names == ["encoder_attention"]
    _build.build()
    _build.build()  # built already: nothing runs
    assert _build.load("encoder_attention")[0] == "loaded"
    _build.load("encoder_attention")  # loaded already: not counted again
    after = counters()
    delta = {k: after[k] - before.get(k, 0.0) for k in after}
    assert delta[("device.kernel.builds", "encoder_attention")] == 1.0
    assert 0.05 <= delta[("device.kernel.build.seconds", "encoder_attention")] < 30.0
    assert delta[("device.kernel.loads", "encoder_attention")] == 1.0


def test_transfer_counters_count_the_executors_staging_copies():
    from pathway_tpu_torch.device import BucketPolicy, DeviceExecutor

    reg = tmetrics.get_registry()
    h2d = reg.counter("device.transfer.h2d.bytes")
    d2h = reg.counter("device.transfer.d2h.bytes")
    ex = DeviceExecutor("cpu", collector_name=None)
    try:
        ex.register("double", lambda x: x * 2.0, policy=BucketPolicy(max_bucket=8))
        rows = np.ones((3, 4), np.float32)
        ex.run_batch("double", (rows,))  # accounting off: nothing counted
        before = (h2d.value, d2h.value)
        assert tprofiler.install_transfer_accounting(force=True)
        try:
            ex.run_batch("double", (rows,))
        finally:
            tprofiler.uninstall_transfer_accounting()
        ex.run_batch("double", (rows,))
    finally:
        ex.close()
    # one padded batch of 4 rows of 4 float32 in, the same out
    assert (h2d.value - before[0], d2h.value - before[1]) == (64.0, 64.0)


def test_dashboard_shows_the_kernel_counters_where_jax_shows_jit_ones():
    from pathway_tpu_torch.internals.monitoring import MonitoringLevel, StatsMonitor

    tprofiler.note_build("encoder_attention", 1.5)
    tprofiler.note_load("encoder_attention")
    footer = StatsMonitor(MonitoringLevel.ALL, console=object())._runtime_summary()
    assert "kernels: " in footer and " build(s) / " in footer and "jit" not in footer


# ---------------------------------------------------------------------------
# The OTLP exporter
# ---------------------------------------------------------------------------


def exported(tel, lic, metrics, endpoint) -> tuple:
    """A run's telemetry against ``endpoint``: a metrics sample, a run span
    and a sampled epoch span; then a queue that overflows with no drain."""
    cfg = tel.TelemetryConfig.create(license=lic.License.new("demo-license-key-with-telemetry-x"),
                                     monitoring_server=endpoint, run_id="r-otlp",
                                     trace_parent="00-" + "ab" * 16 + "-" + "cd" * 8 + "-01")
    reg = metrics.MetricsRegistry(enabled=True)
    reg.histogram("epoch.duration.ms", "", buckets=(1, 10)).observe(2.0)
    t = tel.Telemetry(cfg, interval_s=0.05, registry=reg).start()
    with t.span("pathway.run", workers=1):
        with t.epoch_span(4, 0):
            pass
    time.sleep(0.3)
    t.close()
    # an export queue that nobody drains drops its oldest payloads, counted
    stuck = tel.Telemetry(cfg, registry=reg)
    stuck._q_thread = threading.current_thread()  # "alive": no exporter thread starts
    for _ in range(tel.EXPORT_QUEUE_MAX + 3):
        stuck._enqueue_export("metrics", {"resource": {}, "metrics": {}}, ("http://127.0.0.1:1",))
    return cfg.resource()["root.trace.id"], stuck.dropped_exports, \
        reg.counter("telemetry.export.dropped").value


def test_the_exporter_posts_metrics_and_spans_and_counts_drops():
    import http.server

    from pathway_tpu.internals import license as jlicense
    from pathway_tpu_torch.internals import license as tlicense

    received = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 (http.server API)
            received.append((self.path, json.loads(self.rfile.read(int(self.headers["Content-Length"])))))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    endpoint = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        got = {}
        for name, tel, lic, metrics in (("jax", jtelemetry, jlicense, jmetrics),
                                        ("torch", ttelemetry, tlicense, tmetrics)):
            received.clear()
            out = exported(tel, lic, metrics, endpoint)
            spans = sorted(s["name"] for p, b in received if p == "/v1/traces" for rs in b["resourceSpans"]
                           for ss in rs["scopeSpans"] for s in ss["spans"])
            metric_names = {m["name"] for p, b in received if p == "/v1/metrics" for rm in b["resourceMetrics"]
                            for sm in rm["scopeMetrics"] for m in sm["metrics"]}
            got[name] = (out, spans, {"process.memory.usage", "epoch.duration.ms"} <= metric_names)
    finally:
        server.shutdown()
        server.server_close()
    assert got["torch"] == got["jax"]
    (trace_id, dropped, counted), spans, has_metrics = got["torch"]
    assert trace_id == "ab" * 16 and dropped == counted == 3.0
    assert spans == ["pathway.epoch", "pathway.run"] and has_metrics


@pytest.mark.parametrize("card", [True, False])
def test_a_host_twins_executor_does_not_shadow_the_cards_gauges(card, monkeypatch):
    """Where the process has a card, the CPU's default executor (a host
    twin's) labels its gauges ``device=cpu``: the card's executor keeps the
    unlabelled names ``/status`` and ``top`` read.  Without a card the CPU's
    executor is the only one and keeps them."""
    from pathway_tpu_torch import device as tdev

    earlier = tdev._defaults.get(torch.device("cpu"))
    monkeypatch.setattr(tdev, "_defaults", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    ex = tdev.get_default_executor("cpu")
    reg = tmetrics.get_registry()
    try:
        keys = set(ex.metrics_snapshot())
        collected = set(reg.collect())
    finally:
        ex.close()
        # the process's own CPU executor, if an earlier test made it, keeps
        # its collector
        if earlier is not None:
            reg.register_collector("device.executor:cpu", earlier.metrics_snapshot)
        else:
            reg.unregister_collector("device.executor:cpu")
    labelled = {"device.utilization{device=cpu}", "backlog.device.queue{device=cpu}",
                "device.hbm.bytes_in_use{device=cpu}"}
    plain = {"device.utilization", "backlog.device.queue", "device.hbm.bytes_in_use"}
    assert (labelled if card else plain) <= keys and not (plain if card else labelled) & keys
    assert (labelled if card else plain) <= collected

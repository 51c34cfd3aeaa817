"""The port's device accounting against the JAX package's.

The JAX executor reads FLOPs from XLA's ``cost_analysis()`` once per
compile key; the port counts them once per cache key with a
``TorchFunctionMode`` over the products (plus what a hand kernel reports
through ``note_flops``).  Pinned here: a matmul's FLOPs equal XLA's (2·M·K·N), a
tiny encoder forward's equal the analytic matmul-plus-attention count, a
key with an uncountable product is uncosted (never zero FLOPs), padding
waste, the occupancy histogram and the batch-size distribution equal the
reference's for the same batches, and the snapshot carries the
reference's fields.
"""

from __future__ import annotations

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu.device as jdev
import pathway_tpu_torch.device as tdev
from pathway_tpu.device import telemetry as jtel
from pathway_tpu.engine import metrics as jmetrics
from pathway_tpu_torch.device import telemetry as ttel
from pathway_tpu_torch.engine import metrics as tmetrics

SMALL = {
    "vocab_size": 1000,
    "hidden_size": 128,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "intermediate_size": 512,
    "max_position_embeddings": 128,
}


@pytest.fixture
def pair():
    made = []

    def make():
        j = jdev.DeviceExecutor(collector_name=None)
        t = tdev.DeviceExecutor("cpu", collector_name=None)
        made.extend((j, t))
        return j, t

    yield make
    for ex in made:
        ex.close(timeout_s=2.0)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("small_encoder")
    (d / "config.json").write_text(json.dumps(SMALL))
    return str(d)


def _no_transformers():
    saved = sys.modules.get("transformers", "absent")
    sys.modules["transformers"] = None
    return saved


def _restore(saved):
    if saved == "absent":
        del sys.modules["transformers"]
    else:
        sys.modules["transformers"] = saved


@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (4, 384, 1152), (16, 7, 3)])
def test_matmul_flops_per_key_equal_xla_cost_analysis(pair, m, k, n):
    j, t = pair()
    w = np.random.default_rng(0).normal(size=(k, n)).astype(np.float32)
    x = np.random.default_rng(1).normal(size=(m, k)).astype(np.float32)
    j.register("mm", lambda w, x: x @ w, policy=jdev.BucketPolicy(max_bucket=m))
    t.register("mm", lambda w, x: x @ w, policy=tdev.BucketPolicy(max_bucket=m))
    out_j = j.run_batch("mm", (x,), operands=(jnp.asarray(w),))
    out_t = t.run_batch("mm", (x,), operands=(torch.from_numpy(w),))
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
    [jcost] = j._callables["mm"].costs.values()
    [tcost] = t.costs("mm").values()
    assert tcost["analyzed"] == 1.0
    assert tcost["flops"] == jcost["flops"] == 2.0 * m * k * n
    # compulsory bytes: the weights and the batch read once, the output written once
    assert tcost["argument_bytes"] == 4.0 * (k * n + m * k)
    assert tcost["output_bytes"] == 4.0 * m * n
    assert tcost["bytes_accessed"] == tcost["argument_bytes"] + tcost["output_bytes"]


@pytest.mark.parametrize("cross", [False, True])
def test_tiny_encoder_forward_flops_equal_the_analytic_count(model_dir, cross):
    saved = _no_transformers()
    try:
        import pathway_tpu_torch as pt

        enc = (pt.CrossEncoder if cross else pt.SentenceEncoder)(model_dir, device="cpu")
    finally:
        _restore(saved)
    ex = tdev.get_default_executor("cpu")
    before = set(ex.costs(enc._callable))
    if cross:
        enc.score([("a query", "a short document of words")] * 3)
    else:
        enc.encode(["a short text of words"] * 3)
    [(key, cost)] = [(k, v) for k, v in ex.costs(enc._callable).items() if k not in before]
    B, S = key[0][-1][0]  # the padded [bucket, seq] ids
    H, F, L = SMALL["hidden_size"], SMALL["intermediate_size"], SMALL["num_hidden_layers"]
    per_layer = 2 * B * S * (3 * H * H + H * H + 2 * H * F) + 4 * B * S * S * H
    head = 2 * B * H * H + 2 * B * H if cross else 0
    assert cost["analyzed"] == 1.0
    assert cost["flops"] == L * per_layer + head


def test_an_uncountable_product_leaves_the_key_uncosted(model_dir):
    """W8A8's ``torch._int_mm`` has no FLOP formula: its keys are uncosted,
    and their dispatches are counted as such, never as zero FLOPs."""
    saved = _no_transformers()
    try:
        import pathway_tpu_torch as pt

        enc = pt.SentenceEncoder(model_dir, quantize="int8", device="cpu")
    finally:
        _restore(saved)
    ex = tdev.get_default_executor("cpu")
    enc.encode(["w8a8 text"] * 2)
    before = ex._accountant.snapshot()
    enc.encode(["w8a8 text"] * 2)
    after = ex._accountant.snapshot()
    assert all(c["analyzed"] == 0.0 for c in ex.costs(enc._callable).values())
    assert after["uncosted_dispatches"] == before["uncosted_dispatches"] + 1
    assert after["flops_total"] == before["flops_total"]


def test_the_counting_dispatch_stays_out_of_the_ledger_and_later_ones_are_costed(pair):
    _, t = pair()
    t.register("mm", lambda w, x: x @ w, policy=tdev.BucketPolicy(max_bucket=8))
    w = torch.ones(4, 3)
    x = np.ones((8, 4), np.float32)
    t.run_batch("mm", (x,), operands=(w,))
    snap = t._accountant.snapshot()
    assert snap["costed_dispatches"] == snap["uncosted_dispatches"] == 0
    for _ in range(3):
        t.run_batch("mm", (x,), operands=(w,))
    snap = t._accountant.snapshot()
    assert snap["costed_dispatches"] == 3 and snap["flops_total"] == 3 * 2.0 * 8 * 4 * 3
    assert snap["bytes_accessed_total"] == 3 * 4.0 * (4 * 3 + 8 * 4 + 8 * 3)
    assert snap["device_seconds"] > 0.0
    assert t.metrics_snapshot()["device.achieved.flops_per_s"] > 0.0


def test_a_kernel_outside_the_dispatcher_reports_its_flops(pair):
    _, t = pair()

    def kernel_like(x):
        ttel.note_flops(1234.0)  # what a ctypes-launched kernel's wrapper does
        return x + 1.0

    t.register("k", kernel_like, policy=tdev.BucketPolicy(max_bucket=4))
    t.run_batch("k", (np.ones((4, 2), np.float32),))
    [cost] = t.costs("k").values()
    assert cost["flops"] == 1234.0 and cost["analyzed"] == 1.0
    ttel.note_flops(99.0)  # no count running on this thread: a no-op


def test_cost_analysis_kill_switch_leaves_every_dispatch_uncosted(pair, monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_COST_ANALYSIS", "0")
    _, t = pair()
    t.register("mm", lambda x: x @ x.T, policy=tdev.BucketPolicy(max_bucket=4))
    for _ in range(2):
        t.run_batch("mm", (np.ones((4, 2), np.float32),))
    assert t.costs("mm") == {}
    snap = t._accountant.snapshot()
    assert snap["uncosted_dispatches"] == 2 and snap["costed_dispatches"] == 0


def test_golden_utilization_from_a_fixed_cost(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_PEAK_FLOPS", "1e9")
    for mod, reg in ((jtel, jmetrics), (ttel, tmetrics)):
        acc = mod.CostAccountant(registry=reg.MetricsRegistry(enabled=True))
        assert acc.peak == 1e9 and acc.peak_source == "PATHWAY_DEVICE_PEAK_FLOPS"
        cost = {"flops": 2_000_000.0, "bytes_accessed": 4096.0}
        acc.record_dispatch(cost, duration_s=0.001)
        acc.record_dispatch(cost, duration_s=0.003)
        acc.record_dispatch({"flops": 5.0, "analyzed": 0.0}, duration_s=0.0)
        assert acc.achieved_flops_per_s() == pytest.approx(1e9)
        assert acc.utilization() == pytest.approx(1.0)
        snap = acc.snapshot()
        assert snap["flops_total"] == 4_000_000.0 and snap["uncosted_dispatches"] == 1


def test_peak_flops_table_knob_and_cpu_default(monkeypatch):
    monkeypatch.delenv("PATHWAY_DEVICE_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(ttel, "device_kind", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert ttel.peak_flops() == (989e12, "nvidia h100 80gb hbm3")
    monkeypatch.setattr(ttel, "device_kind", lambda device=None: "cpu")
    peak, source = ttel.peak_flops()
    assert source.startswith("cpu-default") and peak == ttel.CPU_PEAK_FLOPS_PER_CORE * (os.cpu_count() or 1)
    monkeypatch.setenv("PATHWAY_DEVICE_PEAK_FLOPS", "2e12")
    assert ttel.peak_flops() == (2e12, "PATHWAY_DEVICE_PEAK_FLOPS")


def test_accounting_respects_the_metrics_kill_switch():
    acc = ttel.CostAccountant(registry=tmetrics.MetricsRegistry(enabled=False))
    acc.record_batch(5)
    acc.record_dispatch({"flops": 10.0}, 0.1)
    assert acc.snapshot()["flops_total"] == 0.0 and acc.batch_sizes == {}


SIZES = (1, 3, 5, 8, 13, 19, 2, 3)


def test_padding_occupancy_and_batch_sizes_match_the_reference(pair):
    j, t = pair()
    j.register("rowsum", lambda x: jnp.sum(x * x, axis=1), policy=jdev.BucketPolicy(max_bucket=8))
    t.register("rowsum", lambda x: torch.sum(x * x, dim=1), policy=tdev.BucketPolicy(max_bucket=8))
    assert tmetrics.OCCUPANCY_BUCKETS == jmetrics.OCCUPANCY_BUCKETS

    def hist(reg):
        return reg.histogram("device.bucket.occupancy", buckets=tmetrics.OCCUPANCY_BUCKETS).snapshot()[1]

    jh, th = hist(jmetrics.get_registry()), hist(tmetrics.get_registry())
    rng = np.random.default_rng(5)
    for n in SIZES:
        x = rng.normal(size=(n, 3)).astype(np.float32)
        np.testing.assert_allclose(t.run_batch("rowsum", (x,)), j.run_batch("rowsum", (x,)), rtol=1e-6)
    jd = [b - a for a, b in zip(jh, hist(jmetrics.get_registry()))]
    td = [b - a for a, b in zip(th, hist(tmetrics.get_registry()))]
    assert td == jd and sum(td) == 11  # 19 rows split 8 + 8 + 3
    assert t.device_snapshot()["padding"] == j.device_snapshot()["padding"]
    assert t._accountant.snapshot()["batch_sizes"] == j._accountant.snapshot()["batch_sizes"]
    js, ts = j.metrics_snapshot(), t.metrics_snapshot()
    sizes = {k: v for k, v in ts.items() if k.startswith("device.batch.rows")}
    assert sizes == {k: v for k, v in js.items() if k.startswith("device.batch.rows")}


def test_snapshot_and_render_carry_the_reference_fields(pair):
    j, t = pair()
    j.register("rowsum", lambda x: jnp.sum(x, axis=1), policy=jdev.BucketPolicy(max_bucket=4))
    t.register("rowsum", lambda x: torch.sum(x, dim=1), policy=tdev.BucketPolicy(max_bucket=4))
    for ex in (j, t):
        ex.run_batch("rowsum", (np.ones((3, 2), np.float32),))
    js, ts = j.device_snapshot(), t.device_snapshot()
    json.dumps(ts)
    assert set(js) <= set(ts)
    for section in ("cost", "padding", "hbm", "queue", "resilience"):
        assert set(js[section]) == set(ts[section]), section
    assert ts["hbm"]["source"] == "executor"  # no allocator stats on the CPU
    assert ts["callables"] == js["callables"] == {"rowsum": {"dispatches": 1, "cold": 1, "warmed": 0, "keys": 1}}
    rendered = {name: mod.render_device_snapshot(snap) for name, mod, snap in
                (("j", jtel, js), ("t", ttel, ts), ("t_of_j", ttel, js), ("j_of_t", jtel, ts))}
    for text in rendered.values():
        for field in ("utilization", "padding waste", "hbm", "queue", "rowsum"):
            assert field in text
    assert ttel.render_device_snapshot({}) == jtel.render_device_snapshot({})


def test_hbm_falls_back_to_the_tracked_footprint_on_the_cpu(pair):
    _, t = pair()
    assert ttel.hbm_stats(torch.device("cpu")) is None
    snap = t.metrics_snapshot()
    assert snap["device.hbm.bytes_in_use"] == 0.0 and "device.hbm.peak" in snap


def test_capture_trace_writes_a_trace_and_is_counted(tmp_path, monkeypatch):
    monkeypatch.delenv("PATHWAY_DEVICE_TRACE_DIR", raising=False)
    with pytest.raises(ttel.TraceUnavailable):
        ttel.capture_trace(0.01)
    before = tmetrics.get_registry().counter("device.trace.captures").value
    path = ttel.capture_trace(0.05, trace_dir=str(tmp_path))
    assert os.path.isfile(os.path.join(path, "trace.json"))
    assert tmetrics.get_registry().counter("device.trace.captures").value == before + 1

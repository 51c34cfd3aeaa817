"""The port's device fault-tolerance primitives against the JAX package's.

``pathway_tpu_torch/device/resilience.py`` copies the typed failure
classes, the retry schedule, the circuit breaker and the quarantine log of
``pathway_tpu/device/resilience.py``, and redesigns the classifier for
CUDA.  Each test drives the same inputs through both modules (the mirror
of ``tests/test_device_faults.py:88-160``), and the port-only cases pin
the CUDA classification: an out-of-memory error is an OOM, and every
other CUDA error (``torch.AcceleratorError``, a "CUDA error" runtime
error, a kernel's launch failure, a failed build) propagates raw, also
through ``run_batch``.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from pathway_tpu.device import resilience as jres
from pathway_tpu_torch.device import BucketPolicy, DeviceExecutor
from pathway_tpu_torch.device import resilience as tres
from pathway_tpu_torch.engine import faults as tfaults
from pathway_tpu_torch.engine import metrics as tmetrics

MARKER_MESSAGES = [
    "RESOURCE_EXHAUSTED: boom",
    "XLA compilation failed",
    "INTERNAL: link reset",
    "something odd",
    "INTERNAL: zoom_encoder died",
    "OOM while allocating 2GiB",
    "lowering of the custom call failed",
    "UNIMPLEMENTED: op not supported",
]

# the CUDA errors that must reach the caller raw
RAW_CUDA_ERRORS = [
    torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: device-side assert triggered"),
    RuntimeError("encoder_attention kernel launch failed: CUDA error 700"),
    RuntimeError("encoder_attention: cannot encode a TMA tensor map: CUresult 1"),
    RuntimeError("nvcc failed for encoder_attention.cu:\nerror: identifier undefined"),
    RuntimeError("nvcc not found: the port's CUDA kernels are built from source"),
]


def _kind(typed):
    return None if typed is None else (type(typed).__name__, typed.kind)


@pytest.mark.parametrize("message", MARKER_MESSAGES)
def test_classify_injected_markers_match_the_reference(message):
    ref = jres.classify(jres.InjectedDeviceError(message))
    got = tres.classify(tres.InjectedDeviceError(message))
    assert _kind(got) == _kind(ref)
    assert str(got) == str(ref) == message


def test_classify_maps_markers_to_typed_kinds():
    assert tres.classify(tres.InjectedDeviceError("RESOURCE_EXHAUSTED: boom")).kind == "oom"
    assert tres.classify(tres.InjectedDeviceError("XLA compilation failed")).kind == "compile"
    assert tres.classify(tres.InjectedDeviceError("INTERNAL: link reset")).kind == "transient"
    assert isinstance(tres.classify(tres.InjectedDeviceError("something odd")), tres.TransientDeviceError)


def test_classify_refuses_host_bugs_and_passes_typed_through():
    for exc in (ValueError("bad row"), KeyError("missing")):
        assert tres.classify(exc) is None
        assert jres.classify(exc) is None
    already = tres.DeviceOOMError("pre-typed")
    assert tres.classify(already) is already


def test_classify_cuda_out_of_memory_is_an_oom():
    """Port-only: the allocator's error takes the split-and-ratchet path."""
    exc = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    typed = tres.classify(exc)
    assert isinstance(typed, tres.DeviceOOMError) and typed.kind == "oom"
    assert "Tried to allocate" in str(typed)


@pytest.mark.parametrize("exc", RAW_CUDA_ERRORS, ids=lambda e: str(e)[:40])
def test_classify_leaves_cuda_errors_raw(exc):
    """Port-only: sticky CUDA errors, kernel launch failures and build
    failures are not device failures the rail can cure."""
    assert tres.classify(exc) is None


@pytest.mark.parametrize("exc", RAW_CUDA_ERRORS, ids=lambda e: str(e)[:40])
def test_run_batch_raises_cuda_errors_raw_unretried_and_without_fallback(exc, monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_RETRY_BACKOFF_MS", "1")
    tfaults.clear_plan()
    calls = []
    fallbacks = []

    def failing(x):
        calls.append(1)
        raise exc

    def fallback(x):
        fallbacks.append(1)
        return x * 2.0

    ex = DeviceExecutor("cpu", collector_name=None)
    ex.register("cuda_fail", failing, policy=BucketPolicy(max_bucket=8), host_fallback=fallback)
    reg = tmetrics.get_registry()
    retries = reg.counter("device.retry.attempts").value
    fb = reg.counter("device.fallback.batches").value
    try:
        with pytest.raises(type(exc)) as raised:
            ex.run_batch("cuda_fail", (np.ones((3, 4), np.float32),))
    finally:
        ex.close()
    assert raised.value is exc
    assert len(calls) == 1 and not fallbacks
    st = ex.resilience_stats("cuda_fail")
    assert st["failures"] == {} and st["fallback_batches"] == 0
    assert st["breaker"]["consecutive_failures"] == 0
    assert reg.counter("device.retry.attempts").value == retries
    assert reg.counter("device.fallback.batches").value == fb


def test_retry_policy_delays_follow_the_shared_backoff():
    for mod in (jres, tres):
        policy = mod.RetryPolicy(retries=3, deadline_s=30.0, backoff_ms=100.0)
        delays = list(policy.delays())
        assert len(delays) == 3
        assert 0.1 <= delays[0] < 0.15
        assert 0.2 <= delays[1] < 0.25
        assert 0.4 <= delays[2] < 0.45


@pytest.mark.parametrize("backoff_ms", [0.0, 1.0, 7.0, 50.0])
def test_retry_schedule_bounds_match_the_reference(backoff_ms):
    """Same count, same un-jittered base, same jitter width as the udfs
    schedule the reference reuses (the port keeps its own copy)."""
    j = list(jres.RetryPolicy(retries=4, backoff_ms=backoff_ms).delays())
    t = list(tres.RetryPolicy(retries=4, backoff_ms=backoff_ms).delays())
    assert len(j) == len(t) == 4
    base = max(1, int(backoff_ms)) / 1000.0
    jitter = max(0, int(backoff_ms // 2)) / 1000.0
    for i, (a, b) in enumerate(zip(j, t)):
        lo, hi = base * 2**i, base * 2**i + jitter
        assert lo <= a <= hi and lo <= b <= hi


def test_retry_policy_from_env_matches(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_RETRIES", "5")
    monkeypatch.setenv("PATHWAY_DEVICE_RETRY_DEADLINE_S", "2.5")
    monkeypatch.setenv("PATHWAY_DEVICE_RETRY_BACKOFF_MS", "9")
    t, j = tres.RetryPolicy.from_env(), jres.RetryPolicy.from_env()
    assert (t.retries, t.deadline_s, t.backoff_ms) == (j.retries, j.deadline_s, j.backoff_ms) == (5, 2.5, 9.0)


def _breaker_walk(mod) -> list:
    """The reference test's state machine walk, as a sequence of outcomes."""
    b = mod.CircuitBreaker(threshold=2, cooldown_s=0.3)  # long enough that a loaded host reads "fallback" first
    seq = [b.admit(), b.state_name(), b.record_failure(), b.record_failure(), b.state_name(), b.admit()]
    deadline = time.monotonic() + 2.0
    route = b.admit()
    while route == "fallback" and time.monotonic() < deadline:
        time.sleep(0.02)
        route = b.admit()
    seq += [route, b.state_name(), b.admit(), b.record_success(probe=True), b.state_name()]
    b.record_failure()
    b.record_failure()
    deadline = time.monotonic() + 2.0
    while b.admit() != "probe" and time.monotonic() < deadline:
        time.sleep(0.02)
    seq += [b.record_failure(probe=True), b.state_name(), b.snapshot()["trips"]]
    b2 = mod.CircuitBreaker(threshold=1, cooldown_s=0.0)
    b2.record_failure()
    seq += [b2.admit(), b2.state_value(), b2.admit()]
    b2.abort_probe()
    seq += [b2.admit(), b2.record_success(probe=True), b2.state_value(), b2.snapshot()]
    return seq


def test_circuit_breaker_state_machine_matches_the_reference():
    port = _breaker_walk(tres)
    assert port == _breaker_walk(jres)
    assert port[:11] == ["device", "closed", False, True, "open", "fallback",
                         "probe", "half-open", "fallback", True, "closed"]
    assert port[11:14] == [True, "open", 3]


def test_quarantine_log_is_bounded(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_QUARANTINE_KEEP", "2")
    logs = (jres.QuarantineLog.from_env(), tres.QuarantineLog.from_env())
    for log in logs:
        for i in range(5):
            log.add("enc", i, (np.ones((i + 1, 2)),), None, ValueError(f"e{i}"))
    for log in logs:
        assert len(log) == 2 and log.total == 5
        assert [r["rows"] for r in log.records()] == [3, 4]
    strip = lambda recs: [{k: v for k, v in r.items() if k != "ts"} for r in recs]  # noqa: E731
    assert strip(logs[1].records()) == strip(logs[0].records())


def test_quarantine_record_fields_match(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_QUARANTINE_KEEP", "8")
    arrays = (np.zeros((4, 3), np.float32), np.zeros((4,), np.int32))
    dev_err = RuntimeError("INTERNAL: boom")
    out = []
    for mod in (jres, tres):
        rec = mod.QuarantineLog.from_env().add("enc", 3, arrays, dev_err, ValueError("poisoned"))
        rec.pop("ts")
        out.append(rec)
    assert out[0] == out[1]
    assert out[1]["shapes"] == [[4, 3], [4]] and out[1]["dtypes"] == ["float32", "int32"]

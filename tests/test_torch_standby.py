"""Warm-standby promotion in the port against the JAX package.

The scenarios of ``tests/test_standby_promotion.py``: a supervised
2-worker cluster with one warm standby has worker 1 SIGKILLed from outside
once two generations are committed.  Tier one: the standby adopts worker
1's id and the survivors rejoin in place (no restart, no new survivor
process).  Tier two: a ``promote_crash`` fault kills the standby inside
the narrowest promotion window, and recovery falls back to the group
restart.  Both packages run each case; the port's net output must equal
the JAX package's byte for byte (``tests/torch_cluster_programs.py``).
"""

from __future__ import annotations

import json
import threading
from collections import Counter

import pytest

import pathway_tpu  # noqa: F401 - imported once here, inherited by every forked child
import pathway_tpu_torch  # noqa: F401
from pathway_tpu_torch.engine import persistence as pz
from tests import torch_cluster_programs as progs

pytestmark = pytest.mark.chaos


def killed_with_standby(tmp_path, plan: dict | None) -> dict:
    """{package: (SupervisorResult, spawn log, net bytes, scrub report)}."""
    out = {}
    for pkg in progs.PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        procs: dict = {}
        spawn_log: list = []
        killer = threading.Thread(
            target=progs.kill_worker_after_commits, args=(d, procs), daemon=True
        )
        killer.start()
        try:
            res = progs.run_supervised(
                pkg, d, json.dumps(plan) if plan else None, standbys=1,
                procs=procs, spawn_log=spawn_log,
            )
        finally:
            killer.join(timeout=35)
        report = pz.scrub_root(pz.FileBackend(str(d / "pstore")))
        out[pkg] = (res, spawn_log, progs.canonical_bytes(d), report)
    assert out["pathway_tpu_torch"][2] == out["pathway_tpu"][2]
    assert progs.counts_of(out["pathway_tpu_torch"][2]) == progs.EXPECTED_COUNTS
    return out


def test_sigkilled_worker_is_replaced_by_its_standby_without_a_restart(tmp_path):
    for pkg, (res, spawn_log, _net, report) in killed_with_standby(tmp_path, None).items():
        assert res.restarts == 0, (pkg, res.history)
        assert len(res.promotions) == 1, (pkg, res.promotions)
        promo = res.promotions[0]
        assert (promo["worker"], promo["standby"], promo["attempt"]) == (1, 0, 0), (pkg, promo)
        assert "worker 1 exited" in promo["reason"] and promo["duration_s"] >= 0.0, promo
        assert res.exit_codes == [0, 0], (pkg, res.history)
        counts = Counter(spawn_log)
        assert counts[(0, 0)] == 1 and counts[(0, 1)] == 1, (pkg, spawn_log)
        assert all(attempt == 0 for attempt, _wid in spawn_log), (pkg, spawn_log)
        assert counts[(0, 2)] >= 1, (pkg, spawn_log)  # the standby slot
        assert report["ok"] is True, (pkg, report)
        lease = report["lease"]
        assert [p["worker"] for p in lease.get("promotions", [])] == [1], (pkg, lease)
        assert lease.get("fences", {}).get("1") == promo["fence"], (pkg, lease)
        assert not lease.get("promote", {}).get("pending_request"), (pkg, lease)


def test_promote_crash_falls_back_to_the_group_restart(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_STANDBY_PROMOTIONS", "1")
    plan = {"seed": 17, "faults": [{"kind": "promote_crash", "worker": 0, "attempt": 0}]}
    for pkg, (res, _log, _net, report) in killed_with_standby(tmp_path, plan).items():
        assert res.restarts >= 1 and res.exit_codes == [0, 0], (pkg, res.history)
        assert report["ok"] is True, (pkg, report)
        assert not report["lease"].get("promote", {}).get("pending_request"), (pkg, report)


def test_standby_without_a_persistence_root_refuses_like_jax(monkeypatch):
    """``PATHWAY_STANDBY_ID`` on a run with no filesystem root to tail
    raises the same ``RuntimeError`` in both packages."""
    monkeypatch.setenv("PATHWAY_STANDBY_ID", "0")
    messages = []
    for pkg in progs.PACKAGES:
        pw = __import__(pkg)
        with pytest.raises(RuntimeError, match="requires a filesystem persistence root") as err:
            pw.run()
        messages.append(str(err.value))
    assert messages[0] == messages[1]

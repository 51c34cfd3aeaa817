"""Supervised recovery past damaged checkpoints, in the port against JAX.

The two damage cases of ``tests/test_supervised_recovery.py``, run with
the same fault plan in both packages through ``test_torch_supervisor.py``'s
harness: the newest generations corrupted before a kill, and a kill from
inside the checkpoint writer pool with a generation half written.  The
port's net output must equal the JAX package's byte for byte.
"""

from __future__ import annotations

import signal

import pytest

import pathway_tpu  # noqa: F401 - imported once here, inherited by every forked child
import pathway_tpu_torch  # noqa: F401
from tests.torch_cluster_programs import supervised_in_both as both

pytestmark = pytest.mark.chaos


def test_corrupt_newest_generation_falls_back_to_a_verified_one(tmp_path):
    """Worker 0's manifests are bit-flipped from the 2nd on, then worker 1
    is killed: recovery rejects the damaged generations and resumes from
    an older verified one, in both packages."""
    plan = {"seed": 13, "faults": [
        {"kind": "blob_bitflip", "key": "manifests/0/", "from_nth": 2, "attempt": 0},
        {"kind": "crash", "worker": 1, "at_epoch": 25, "attempt": 0},
    ]}
    for pkg, (res, _net, _report) in both(tmp_path, plan, gated=True).items():
        assert res.restarts >= 1 and res.history[0][1] == -signal.SIGKILL, (pkg, res.history)
        assert res.exit_codes == [0, 0], (pkg, res.history)
        assert "worker 1" in res.last_failure, pkg
        info = res.recovery[0]
        assert info["rejected"] and info["recovered_from"] >= 1, (pkg, info)
        assert all(g > info["recovered_from"] for g, _why in info["rejected"]), (pkg, info)
        assert info["generation"] > info["recovered_from"], (pkg, info)


def test_kill_mid_async_commit_recovers_and_scrubs_clean(tmp_path):
    """``writer_crash`` SIGKILLs worker 0 from its checkpoint writer pool
    with a generation half written: recovery resumes from the last landed
    one, and no partial generation is reachable afterwards."""
    plan = {"seed": 23, "faults": [
        {"kind": "writer_crash", "worker": 0, "key": "snapshots/", "nth": 12, "attempt": 0},
    ]}
    for pkg, (res, _net, report) in both(tmp_path, plan, gated=True).items():
        assert res.restarts >= 1 and res.history[0][0] == -signal.SIGKILL, (pkg, res.history)
        assert res.exit_codes == [0, 0], (pkg, res.history)
        assert report["ok"] is True, (pkg, report)

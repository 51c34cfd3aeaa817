"""Elastic rescale and degraded shrink in the port against the JAX package.

The rescale cases of ``tests/test_supervised_recovery.py``: a supervised
root checkpointed at 4 workers (killed mid-async-commit) resumes at 2 and
again at 4, each phase repartitioning the committed state by shard range;
and a worker lost on every attempt of a spent budget shrinks the cluster
from 2 to 1.  Each phase runs in both packages on the same plan; the
port's net output must equal the JAX package's byte for byte, with the
same rescale provenance (``tests/torch_cluster_programs.py``).
"""

from __future__ import annotations

import json
import signal

import pytest

import pathway_tpu  # noqa: F401 - imported once here, inherited by every forked child
import pathway_tpu_torch  # noqa: F401
from pathway_tpu_torch.engine import persistence as pz
from tests import torch_cluster_programs as progs

pytestmark = pytest.mark.chaos

WRITER_CRASH = json.dumps({"seed": 23, "faults": [
    {"kind": "writer_crash", "worker": 0, "key": "snapshots/", "nth": 12, "attempt": 0},
]})


def test_rescale_round_trip_4_2_4_under_a_mid_commit_kill(tmp_path):
    nets = {}
    for pkg in progs.PACKAGES:
        root = tmp_path / pkg
        root.mkdir()
        phases = []
        for phase, (n, plan) in enumerate([(4, WRITER_CRASH), (2, None), (4, None)]):
            out = f"counts-{phase}.jsonl"
            res = progs.run_supervised(pkg, root, plan, n=n, gated=True, out_name=out)
            phases.append(progs.canonical_bytes(root, out, 4))
            if phase == 0:
                assert res.restarts >= 1 and res.history[0][0] == -signal.SIGKILL, (pkg, res.history)
            else:
                assert res.restarts == 0 and res.exit_codes == [0] * n, (pkg, res.history)
                assert res.recovery[0]["topology"] == n, (pkg, res.recovery)
                assert res.recovery[0]["repartitioned_from"] == 6 - n, (pkg, res.recovery)
        report = pz.scrub_root(pz.FileBackend(str(root / "pstore")))
        assert report["ok"] is True, (pkg, report)
        assert [h["workers"] for h in report["topology"]["history"]] == [4, 2, 4], (pkg, report)
        nets[pkg] = phases
    assert nets["pathway_tpu_torch"] == nets["pathway_tpu"]
    for net in nets["pathway_tpu_torch"]:
        assert progs.counts_of(net) == progs.EXPECTED_COUNTS


def test_degraded_shrink_completes_the_run_at_the_surviving_count(tmp_path):
    """Worker 1 dies at epoch 14 on every attempt (a lost host): with
    ``shrink_on_loss`` the supervisor rescales 2 -> 1 and the run ends with
    the exactly-once output, the dead worker's part file swept."""
    plan = {"seed": 31, "faults": [{"kind": "crash", "worker": 1, "at_epoch": 14}]}
    runs = progs.supervised_in_both(
        tmp_path, plan, n=2, max_restarts=1, shrink_on_loss=True, gated=True,
    )
    for pkg, (res, _net, report) in runs.items():
        assert [(r["from"], r["to"], r["lost_worker"]) for r in res.rescales] == [(2, 1, 1)], pkg
        assert res.exit_codes == [0], (pkg, res.history)
        assert not (tmp_path / pkg / "counts.jsonl.part-1").exists(), pkg
        assert res.recovery[0]["topology"] == 1, (pkg, res.recovery)
        assert res.recovery[0]["repartitioned_from"] == 2, (pkg, res.recovery)
        assert report["ok"] is True, (pkg, report)
        lease = pz.read_lease_file(str(tmp_path / pkg / "pstore"))
        assert lease["workers"] == 1 and [h["workers"] for h in lease["topology_history"]] == [2, 1]

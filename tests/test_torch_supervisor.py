"""Supervised crash recovery in the port against the JAX package.

The scenarios of ``tests/test_supervised_recovery.py`` and
``test_recovery_kill.py``: a streaming groupby over a Python subject,
persisted every 50 ms, runs as a supervised cluster under a seeded fault
plan; the supervisor rolls the group back to the last committed (and
verified) checkpoint and respawns it.  Each case runs the same plan in
both packages; the port's net output must equal the JAX package's byte
for byte and be the exactly-once totals, its supervisor must report the
same story (restarts, exit codes, recovery provenance), and the root must
scrub clean (``tests/torch_cluster_programs.py``).  Damaged
checkpoints are in ``test_torch_recovery_damage.py``, rescales in
``test_torch_rescale.py``.
"""

from __future__ import annotations

import json
import signal

import pytest

import pathway_tpu  # noqa: F401 - imported once here, inherited by every forked child
import pathway_tpu_torch  # noqa: F401
from tests import torch_cluster_programs as progs
from tests.torch_cluster_programs import supervised_in_both as both

pytestmark = pytest.mark.chaos


@pytest.mark.parametrize("n", [1, 2])
def test_sigkill_recovered_by_group_restart_byte_identical(tmp_path, n):
    """SIGKILL the last worker at epoch 3 (attempt 0 only): one restart,
    the recovered group exits clean, the root scrubs clean."""
    plan = {"seed": 7, "faults": [{"kind": "crash", "worker": n - 1, "at_epoch": 3, "attempt": 0}]}
    for pkg, (res, _net, report) in both(tmp_path, plan, n=n).items():
        assert res.restarts >= 1, (pkg, res.history)
        assert res.history[0][n - 1] == -signal.SIGKILL, (pkg, res.history)
        assert res.exit_codes == [0] * n, (pkg, res.history)
        assert report["ok"] is True, (pkg, report)


def test_transient_comm_fault_absorbed_without_restart(tmp_path):
    """One dropped frame mid-exchange is absorbed by heartbeat, reconnect
    and resync: zero restarts, exactly-once output."""
    plan = {"seed": 11, "faults": [{"kind": "comm_drop", "worker": 0, "peer": 1, "nth": 4}]}
    for pkg, (res, _net, _report) in both(tmp_path, plan, max_restarts=0).items():
        assert res.restarts == 0 and res.exit_codes == [0, 0], (pkg, res.history)


@pytest.mark.parametrize("pkg", progs.PACKAGES)
def test_restart_budget_is_spent_then_the_supervisor_gives_up(tmp_path, pkg):
    supervisor = __import__(f"{pkg}.engine.supervisor", fromlist=["SupervisorError"])
    plan = json.dumps({"faults": [{"kind": "crash", "worker": 0, "at_epoch": 0}]})
    with pytest.raises(supervisor.SupervisorError, match="restart budget"):
        progs.run_supervised(pkg, tmp_path, plan, max_restarts=1)

"""``python -m pathway_tpu_torch spawn`` and ``spawn-from-env``.

The port's argparse CLI (``cli.main``, called here in the test process,
so only the workers pay an interpreter start) launches real worker
processes of a program file — one of ``tests/torch_cluster_programs.py``'s
programs run through a short script — and their net output must be the
exactly-once totals that ``tests/test_torch_supervisor.py`` holds to the
JAX package: a supervised cluster that recovers from a seeded crash and
prints the JAX package's provenance line, a cluster with a warm standby,
and the k8s ``spawn-from-env`` hook re-executing ``spawn``.  Record and
replay, and ``--torch-distributed``, are in ``test_torch_cli_replay.py``.
"""

from __future__ import annotations

import json
import os
import sys

import pytest

from pathway_tpu_torch import cli
from tests import torch_cluster_programs as progs

SCRIPT = (
    "import sys\n"
    "sys.path.insert(0, {repo!r})\n"
    "import importlib\n"
    "from tests import torch_cluster_programs as progs\n"
    "pw = importlib.import_module('pathway_tpu_torch')\n"
    "progs.PROGRAMS[{program!r}](pw, {tmpdir!r})\n"
)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_program(tmpdir, program: str):
    script = tmpdir / "prog.py"
    script.write_text(SCRIPT.format(repo=REPO, program=program, tmpdir=str(tmpdir)))
    return str(script)


def spawn(monkeypatch, capfd, tmpdir, program, *args, command="spawn", script=None):
    """``cli.main([command, *args, ...])`` in this process; (exit code,
    stderr, stdout).  The workers inherit this process's environment."""
    for name, value in dict(PYTHONPATH=REPO, PATHWAY_COMM_HEARTBEAT_S="0.5",
                            CUDA_VISIBLE_DEVICES="").items():
        monkeypatch.setenv(name, value)
    argv = [command, *args, "--first-port", str(progs.free_port_base(4)), sys.executable,
            script or write_program(tmpdir, program)]
    with pytest.raises(SystemExit) as done:
        cli.main(argv)
    captured = capfd.readouterr()
    return done.value.code, captured.err, captured.out


@pytest.mark.chaos
def test_supervised_spawn_recovers_a_crash(tmp_path, monkeypatch, capfd):
    monkeypatch.setenv("PATHWAY_FAULT_PLAN", json.dumps(
        {"seed": 7, "faults": [{"kind": "crash", "worker": 1, "at_epoch": 3, "attempt": 0}]}
    ))
    code, err, _out = spawn(monkeypatch, capfd, tmp_path, "streaming_counts", "-n", "2", "--supervise",
                           "--checkpoint-root", str(tmp_path / "pstore"))
    assert code == 0, err[-3000:]
    assert "[pathway_tpu_torch] recovered after 1 restart(s)" in err, err[-3000:]
    assert progs.counts_of(progs.canonical_bytes(tmp_path)) == progs.EXPECTED_COUNTS


def test_spawn_with_a_standby_runs_to_its_end(tmp_path, monkeypatch, capfd):
    code, err, _out = spawn(monkeypatch, capfd, tmp_path, "streaming_counts", "-n", "2", "--supervise",
                           "--standbys", "1", "--checkpoint-root", str(tmp_path / "pstore"))
    assert code == 0, err[-3000:]
    assert "recovered after" not in err
    assert progs.counts_of(progs.canonical_bytes(tmp_path)) == progs.EXPECTED_COUNTS


def test_spawn_from_env_reexecs_spawn_with_its_arguments(monkeypatch, capfd):
    """The hook re-executes ``python -m pathway_tpu_torch spawn`` with the
    arguments of ``PATHWAY_SPAWN_ARGS`` (the exec itself is caught here), and
    says so and exits 0 without them, as the JAX package's does."""
    calls = []
    monkeypatch.setattr(os, "execl", lambda *argv: calls.append(argv))
    monkeypatch.delenv("PATHWAY_SPAWN_ARGS", raising=False)
    assert cli.main(["spawn-from-env"]) == 0
    assert "PATHWAY_SPAWN_ARGS variable is unspecified" in capfd.readouterr().err
    monkeypatch.setenv("PATHWAY_SPAWN_ARGS", "-n 2 --supervise python prog.py")
    cli.main(["spawn-from-env"])
    assert calls == [(sys.executable, sys.executable, "-m", "pathway_tpu_torch", "spawn",
                      "-n", "2", "--supervise", "python", "prog.py")]

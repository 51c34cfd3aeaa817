"""The port's SIGKILL matrix (``tests/test_persistence_matrix.py``).

A forked child runs ``tests/torch_persistence_programs.py``'s
:func:`kill_worker` on the port's pure-Python core: a Python subject of 24
rows, one commit each, through a pipeline shape into a jsonlines sink,
persisted with input or operator snapshots every 50 ms.  The parent
SIGKILLs it once output appears, then runs it again to its end on the
same root; the last run's net output must be the JAX package's expected
exactly-once state.  Cases: {groupby, join} × {input, operator}, a double
crash, ``deduplicate``, and a resume from a clean finish.
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import time

import pytest

import pathway_tpu_torch  # noqa: F401 - imported once here, inherited by every forked child
from tests import torch_persistence_programs as progs

EXPECTED = {
    "groupby": {0: 8, 1: 8, 2: 8},
    "join": {"zero": 8, "one": 8, "two": 8},
}


def start(pstore: str, out: str, shape: str, mode: str, row_delay: float):
    ctx = multiprocessing.get_context("fork")
    proc = ctx.Process(
        target=progs.kill_worker,
        args=("pathway_tpu_torch", pstore, out, shape, mode, progs.KILL_ROWS, row_delay),
        daemon=True,
    )
    proc.start()
    return proc


def kill_resume(tmp_path, shape: str, mode: str, kills: int = 1) -> dict:
    pstore = str(tmp_path / "pstore")
    for attempt in range(kills):
        out = str(tmp_path / f"out{attempt}.jsonl")
        proc = start(pstore, out, shape, mode, progs.KILL_ROW_DELAY_S)
        deadline = time.monotonic() + 30
        while not (os.path.exists(out) and os.path.getsize(out) > 0):
            if time.monotonic() > deadline:
                proc.terminate()
                pytest.fail(f"worker {attempt} produced no output within 30s")
            time.sleep(0.02)
        time.sleep(3 * progs.KILL_ROW_DELAY_S)
        os.kill(proc.pid, signal.SIGKILL)
        proc.join(10)
        if proc.exitcode == 0:
            break  # finished before the kill: still a resume from complete
        assert proc.exitcode == -signal.SIGKILL, proc.exitcode
    final_out = str(tmp_path / "final.jsonl")
    proc = start(pstore, final_out, shape, mode, 0.0)
    proc.join(60)
    assert proc.exitcode == 0, proc.exitcode
    return progs.net_state(final_out)


@pytest.mark.parametrize("mode", ["input", "operator"])
@pytest.mark.parametrize("shape", ["groupby", "join"])
def test_kill_resume_matrix(tmp_path, shape, mode):
    assert kill_resume(tmp_path, shape, mode) == EXPECTED[shape]


@pytest.mark.parametrize("mode", ["input", "operator"])
def test_double_crash_then_resume(tmp_path, mode):
    assert kill_resume(tmp_path, "groupby", mode, kills=2) == EXPECTED["groupby"]


@pytest.mark.parametrize("mode", ["input", "operator"])
def test_deduplicate_state_survives_kill(tmp_path, mode):
    # deduplicate(acceptor=always) keeps exactly one live row: count 1
    assert list(kill_resume(tmp_path, "deduplicate", mode).values()) == [1]


def test_resume_from_clean_finish_is_noop(tmp_path):
    pstore = str(tmp_path / "pstore")
    for name in ("a", "b"):
        out = str(tmp_path / f"{name}.jsonl")
        proc = start(pstore, out, "groupby", "input", 0.0)
        proc.join(60)
        assert proc.exitcode == 0
        assert progs.net_state(out) == EXPECTED["groupby"]

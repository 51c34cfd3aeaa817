"""The port's autoscaler against the JAX package's.

``ScaleController`` is pure logic over (staleness, backlog) readings: the
same sequence fed to both packages' controllers must give the same
decisions, entry for entry (the hysteresis cases of
``tests/test_autoscaler.py`` and seeded random walks).  The load beacons,
the state file and its panel gauges, and ``comm.moving_shards`` are held
to the JAX package's on the same inputs.

End to end, a supervised cluster under ``--autoscale`` with no freshness
tracker reads calm (no staleness, no backlog), as the JAX package does
with ``PATHWAY_FRESHNESS=0``: both packages shrink 2 -> 1 once idle, by
live handoff, and keep their net output byte-identical.  With the
tracker on, a seeded load spike grows the port's cluster 1 -> 2 and
idleness shrinks it back, its net output the JAX package's clean run's.
"""

from __future__ import annotations

import json
import random

import pytest

import pathway_tpu  # noqa: F401 - imported once here, inherited by every forked child
from pathway_tpu.engine import autoscaler as jasc
from pathway_tpu.engine import comm as jcomm
from pathway_tpu_torch.engine import autoscaler as tasc
from pathway_tpu_torch.engine import comm as tcomm
from tests import torch_cluster_programs as progs

KNOBS = dict(
    current=2, min_workers=1, max_workers=4, staleness_hi_s=1.0, dwell_s=2.0,
    cooldown_s=5.0, idle_dwell_s=3.0, budget=10,
)


def oscillating():
    return [(0.5 * (i + 1), 5.0 if i % 2 else 0.1, 0.0) for i in range(400)]


def dip_then_hold():
    return [(0.0, 5.0, 0.0), (1.5, 5.0, 0.0), (1.6, 0.2, 3.0), (2.0, 5.0, 0.0),
            (3.5, 5.0, 0.0), (4.1, 5.0, 0.0), (4.2, 5.0, 0.0)]


def hot_through_cooldown():
    return [(t * 0.5, 5.0, 2.0) for t in range(40)]


def idle_to_floor():
    return [(t * 0.5, 0.1, 0.0) for t in range(60)]


def low_staleness_with_backlog():
    return [(t * 0.5, 0.1, 7.0) for t in range(40)]


def random_walk(seed):
    rng = random.Random(seed)
    now, out = 0.0, []
    for _ in range(600):
        now += rng.choice([0.1, 0.5, 1.0, 2.0])
        out.append((now, rng.choice([0.0, 0.2, 0.6, 1.5, 4.0]), rng.choice([0.0, 0.0, 3.0])))
    return out


SEQUENCES = {
    "oscillating": (oscillating, {}),
    "dip": (dip_then_hold, {}),
    "cooldown": (hot_through_cooldown, {"max_workers": 8}),
    "idle_floor": (idle_to_floor, {"current": 3}),
    "backlog": (low_staleness_with_backlog, {}),
    "cap": (hot_through_cooldown, {"current": 4}),
    "budget": (hot_through_cooldown, {"max_workers": 64, "budget": 2, "cooldown_s": 0.5}),
    "walk_0": (lambda: random_walk(0), {}),
    "walk_1": (lambda: random_walk(1), {"budget": 3}),
    "walk_2": (lambda: random_walk(2), {"min_workers": 2, "max_workers": 3, "dwell_s": 0.0}),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_controller_decisions_equal_jax_on_the_same_readings(name):
    make, overrides = SEQUENCES[name]
    knobs = {**KNOBS, **overrides}
    controllers = [mod.ScaleController(**knobs) for mod in (jasc, tasc)]
    for now, staleness, backlog in make():
        got = [c.observe(now, staleness, backlog) for c in controllers]
        assert got[0] == got[1], (name, now)
    jax_c, port_c = controllers
    assert list(port_c.decisions) == list(jax_c.decisions)
    assert port_c.snapshot(1e6) == jax_c.snapshot(1e6)
    if name == "oscillating":
        assert not port_c.decisions


def test_beacons_state_file_and_moving_shards_equal_jax(tmp_path):
    for pkg_asc, root in ((jasc, tmp_path / "j"), (tasc, tmp_path / "t")):
        root.mkdir()
        pkg_asc.write_load_beacon(str(root), 0, staleness_s=1.5, backlog=3, epochs=7)
        pkg_asc.write_load_beacon(str(root), 1, staleness_s=0.5, backlog=2, epochs=9)
        c = pkg_asc.ScaleController(**{**KNOBS, "dwell_s": 0.5, "cooldown_s": 60.0, "budget": 3})
        c.observe(0.0, 5.0, 2.0)
        assert c.observe(0.6, 5.0, 2.0) is not None
        c.write_state(str(root), 0.6)
    # each package reads the other's files
    for reader, root in ((jasc, tmp_path / "t"), (tasc, tmp_path / "j")):
        beacons = reader.read_load_beacons(str(root), 2)
        assert sorted(beacons) == [0, 1] and reader.worst_load(beacons) == (1.5, 5.0)
    assert tasc.state_metrics(str(tmp_path / "t")) == jasc.state_metrics(str(tmp_path / "j"))
    assert tasc.state_metrics(str(tmp_path / "t"))["autoscaler.target.workers"] == 3.0
    tasc.clear_load_beacons(str(tmp_path / "t"), 2)
    assert tasc.read_load_beacons(str(tmp_path / "t"), 2) == {}
    assert tasc.worst_load({}) == jasc.worst_load({}) == (0.0, 0.0)
    for n_old, n_new in ((1, 1), (1, 2), (2, 3), (3, 2), (2, 4), (5, 7)):
        assert tcomm.moving_shards(n_old, n_new) == jcomm.moving_shards(n_old, n_new)


@pytest.mark.chaos
def test_calm_cluster_shrinks_by_live_handoff_like_jax(tmp_path, monkeypatch):
    for knob, value in {
        "PATHWAY_AUTOSCALE": "1", "PATHWAY_AUTOSCALE_MIN_WORKERS": "1",
        "PATHWAY_AUTOSCALE_MAX_WORKERS": "2", "PATHWAY_AUTOSCALE_IDLE_S": "0.5",
        "PATHWAY_AUTOSCALE_COOLDOWN_S": "30", "PATHWAY_AUTOSCALE_HANDOFF_DEADLINE_S": "20",
        "PATHWAY_FRESHNESS": "0",
    }.items():
        monkeypatch.setenv(knob, value)
    nets = {}
    for pkg in progs.PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        res = progs.run_supervised(pkg, d, None, n=2, autoscale=True)
        actions = [(r.get("kind"), r.get("action"), r["from"], r["to"]) for r in res.rescales]
        assert actions and actions[0][1:] == ("shrink", 2, 1), (pkg, res.rescales)
        assert actions[0][0] in ("autoscale", "autoscale-fallback"), (pkg, res.rescales)
        assert res.exit_codes == [0], (pkg, res.history)
        nets[pkg] = progs.canonical_bytes(d)
    assert nets["pathway_tpu_torch"] == nets["pathway_tpu"]
    assert progs.counts_of(nets["pathway_tpu"]) == progs.EXPECTED_COUNTS


SPIKE_ROWS = 160  # tests/test_autoscaler.py:667: a grow and a shrink both land mid-stream
SPIKE = {"kind": "load_spike", "source": "SubjectReader", "nth": 80, "delay_ms": 2500, "attempt": 0}


@pytest.mark.chaos
def test_load_spike_grows_then_shrinks_back_byte_identical(tmp_path, monkeypatch):
    """``tests/test_autoscaler.py:828`` on the port: a seeded load spike
    holds the workers' freshness staleness past the threshold, so the
    controller grows 1→2 by live shard handoff; once the spike ends,
    sustained idleness shrinks 2→1.  Budget 2 pins the sequence.  The net
    output is byte-identical to the JAX package's clean unscaled run of
    the same rows, the root scrubs clean and no handoff request is left."""
    from pathway_tpu_torch.engine import metrics as tmetrics
    from pathway_tpu_torch.engine import persistence as tpz

    clean = tmp_path / "clean"
    clean.mkdir()
    res = progs.run_supervised("pathway_tpu", clean, None, n=1, n_rows=SPIKE_ROWS)
    assert res.restarts == 0 and res.exit_codes == [0], res.history
    for knob, value in {
        "PATHWAY_AUTOSCALE": "1", "PATHWAY_AUTOSCALE_MIN_WORKERS": "1",
        "PATHWAY_AUTOSCALE_MAX_WORKERS": "2", "PATHWAY_AUTOSCALE_STALENESS_S": "0.6",
        "PATHWAY_AUTOSCALE_DWELL_S": "0.6", "PATHWAY_AUTOSCALE_COOLDOWN_S": "1.0",
        "PATHWAY_AUTOSCALE_IDLE_S": "0.7", "PATHWAY_AUTOSCALE_HANDOFF_DEADLINE_S": "20",
        "PATHWAY_AUTOSCALE_BUDGET": "2",
    }.items():
        monkeypatch.setenv(knob, value)

    def handoffs():
        return tmetrics.get_registry().scalar_metrics().get("supervisor.handoffs", 0.0)

    scaled = tmp_path / "scaled"
    scaled.mkdir()
    before = handoffs()
    res = progs.run_supervised("pathway_tpu_torch", scaled, json.dumps({"seed": 11, "faults": [SPIKE]}),
                               n=1, autoscale=True, n_rows=SPIKE_ROWS)
    moves = [(r.get("action"), r["from"], r["to"]) for r in res.rescales]
    assert moves == [("grow", 1, 2), ("shrink", 2, 1)], res.rescales
    # the grow lands mid-spike as a live handoff; the shrink races the end
    # of the stream and may take the restart fallback, as provenance says
    assert res.rescales[0]["kind"] == "autoscale", res.rescales
    if res.rescales[1]["kind"] == "autoscale":
        assert res.last_failure is None and handoffs() == before + 2
    else:
        assert res.rescales[1]["kind"] == "autoscale-fallback", res.rescales
        assert "falling back" in res.last_failure and handoffs() == before + 1
    assert progs.canonical_bytes(scaled) == progs.canonical_bytes(clean) != b"[]"
    root = str(scaled / "pstore")
    report = tpz.scrub_root(tpz.FileBackend(root))
    assert report["ok"] is True, report
    assert tpz.read_handoff_request(root) is None
    actions = [d.get("action") for d in tasc.read_state_file(root)["decisions"]]
    assert "grow" in actions and "shrink" in actions

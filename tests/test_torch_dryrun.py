"""The port's ``dryrun_multichip`` (``parallel/dryrun.py``), the counterpart
of ``__graft_entry__.py::dryrun_multichip`` (``tests/test_parallel.py:135-143``
runs that one at 8 devices): one step of every distributed path, at its
tiny shapes, on every rank of gloo worlds of 2 and 4 (``tests/gloo_model_ranks.py``).
Each check inside raises on a non-finite result or wrong ids; a world of
another size than the caller's raises ``ValueError``.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from tests import gloo_model_ranks as gm  # noqa: E402
from tests import gloo_ranks as g  # noqa: E402

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    started = {w: g.RankGroup(gm.dryrun_case, w, tmp_path_factory.mktemp(f"dryrun{w}")) for w in WORLDS}
    yield started
    for group in started.values():
        group.stop()


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_multichip_runs_on_every_rank(groups, world):
    results = groups[world].results()
    assert len(results) == world
    for refusal in results:
        assert refusal.startswith("ValueError") and "world of" in refusal

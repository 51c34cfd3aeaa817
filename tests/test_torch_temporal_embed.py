"""``chip_smoke.py``'s ``[temporal]`` program at a small size, in both
packages: 128 events over 6 hours in 8 commits (a share of them late), 16
alerts and 8 questions, staged as epochs by ``pw.debug.table_from_rows``,
embedded by an async ``pw.udf`` through the package's ``AsyncMicroBatcher``
over its ``SentenceEncoder`` (2 layers, H=128; the port's carries the JAX
encoder's weights, the JAX one runs its Pallas attention in interpret
mode), then windowed, joined and answered as on the card.  Keys, times,
diffs and every column but the vectors and the dot products built on them
are equal; vectors at cosine > 0.999 (``tests/test_attention_kernel.py:119``)
and dot products of unit vectors within sqrt(2·(1 − 0.999)), the bound
that cosine gives.  The port's row path gives its columnar path's streams,
and its streams pass the phase's own gates against the plain replay.
"""

from __future__ import annotations

import numpy as np
import pytest

import chip_smoke
import pathway_tpu as pj
import pathway_tpu_torch as pt
from pathway_tpu_torch.internals import vector_compiler as vc
from tests import torch_dataflow_programs as P
from tests.test_torch_dataflow_embed import COS_MIN, SCORE_TOL, model  # noqa: F401  (its encoder fixture)

PATHS = (True, False)


@pytest.fixture(scope="module")
def embedded(model) -> dict:  # noqa: F811
    from pathway_tpu_torch.device import get_default_executor

    _, _, jenc, tenc = model
    out = {"jax": P.capture_temporal_embedding(pj, jenc.encode)}
    for columnar in PATHS:
        vc.set_enabled(columnar)
        try:
            out[columnar] = P.capture_temporal_embedding(pt, tenc.encode, executor=get_default_executor("cpu"))
        finally:
            vc.set_enabled(True)
            pt.G.clear()
    return out


def _cos(a, b) -> float:
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


VECTORS, DOTS = ("vec", "vsum"), ("best", "score")


def _by_key(deltas) -> list:
    return sorted(deltas, key=lambda e: e[:3])


def test_temporal_embedding_matches_jax(embedded):
    want, got = embedded["jax"], embedded[True]
    assert sorted(got) == sorted(want)
    for table, deltas in want.items():
        deltas, mine = _by_key(deltas), _by_key(got[table])
        assert deltas, table
        assert [d[:3] for d in mine] == [d[:3] for d in deltas], table
        for (*_, w), (*_, g) in zip(deltas, mine):
            assert g.keys() == w.keys()
            for col, value in w.items():
                if col in VECTORS:
                    assert _cos(g[col], value) > COS_MIN, (table, col)
                elif col in DOTS:
                    assert abs(g[col] - value) <= SCORE_TOL, (table, col)
                else:
                    assert g[col] == value, (table, col)


def test_temporal_embedding_row_path_matches_columnar(embedded):
    for table, deltas in embedded[True].items():
        deltas, got = _by_key(deltas), _by_key(embedded[False][table])
        assert [d[:3] for d in got] == [d[:3] for d in deltas], table
        for (*_, a), (*_, b) in zip(deltas, got):
            assert all(np.array_equal(a[c], b[c]) if isinstance(a[c], np.ndarray) else a[c] == b[c] for c in a), table


def test_temporal_run_passes_the_phase_gates(embedded):
    """The port's streams, as ``[temporal]`` records them, against the
    phase's plain replay of the epochs they had (the embedded rows in the
    order the run delivered them): every gate holds."""
    got = embedded[True]
    captured = {name: [(k, row, t, d > 0) for t, k, d, row in deltas] for name, deltas in got.items()}
    epochs: dict = {}
    for t, _k, _d, row in got["embedded"]:
        epochs.setdefault(t, []).append(tuple(row[c] for c in ("n", "kind", "t", "topic", "batch", "vec")))
    replay = chip_smoke.temporal_replay([epochs[t] for t in sorted(epochs)])
    run = {name: chip_smoke.final_rows(rows) for name, rows in captured.items()}
    run["hourly_stream"], run["answers_stream"] = captured["hourly"], captured["answers"]
    res = chip_smoke.temporal_checks(run, replay)
    assert res["sliding_mismatched"] == res["hourly_mismatched"] == res["answers_revised"] == 0, res
    assert res["sessions_equal"] and res["hourly_stream_equal"] and res["alert_counts_equal"], res
    assert res["answer_windows_equal"] and res["answers"] == len(replay["answers"]) > 0, res
    assert max(res["sliding_sum_rel"], res["hourly_sum_rel"], res["alert_best_err"], res["answer_score_err"]) \
        <= chip_smoke.TEMPORAL_REL, res
    assert res["alert_pairs"] > 0 and replay["dropped"] > 0, res

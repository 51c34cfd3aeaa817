"""The port's Table-API indexes held to the JAX package's.

``tests/torch_dataflow_programs.py::index_program`` runs in both packages:
a ``DataIndex`` over ``BruteForceKnn`` (COS, L2SQ, IP) or ``LshKnn``, its
data table gaining and losing rows between epochs, queries with their own
``k`` and a metadata filter, through ``query_as_of_now`` and ``query`` with
``collapse_rows`` both ways.  Below 256 rows both packages score on the
host in numpy, so the streams are equal bit for bit; at 320 rows the index
runs its device top-k (the port's on the CPU, in f32), and ids are held
equal but at ties, scores within 1e-2 (the index's pin).
"""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from tests import torch_dataflow_programs as progs

PACKAGES = (jpw, tpw)
SCORE_TOL = 1e-2


@pytest.fixture(autouse=True)
def clean_graphs():
    for pw in PACKAGES:
        pw.G.clear()
    yield
    for pw in PACKAGES:
        pw.G.clear()


def streams(metric: str, inner: str, **kw) -> list[dict]:
    return [progs.capture(pw, progs.index_program(pw, metric, inner, **kw)) for pw in PACKAGES]


@pytest.mark.parametrize("metric,inner", [("COS", "brute"), ("L2SQ", "brute"), ("IP", "brute"), ("COS", "lsh")])
def test_index_queries_match_jax(metric, inner):
    jax, port = streams(metric, inner)
    for name, stream in jax.items():
        assert any(d < 0 for _t, _k, d, _r in stream), name  # data changes revise answers
    assert port == jax


def test_query_as_of_now_revises_answers_as_query_does():
    """In the JAX package both methods lower onto one operator, which
    re-answers a standing query when the data changes; the port keeps it."""
    jax, port = streams("COS", "brute")
    assert port == jax
    for stream in (jax, port):
        assert stream["query_as_of_now:True"] == stream["query:True"]
        assert {t for t, _k, d, _r in stream["query_as_of_now:True"] if d < 0} == {4, 6}


def states(stream, times) -> dict:
    """``{time: {query key: (names, scores)}}`` of a collapsed stream
    (columns k, filt, name, meta, scores): each query's live answer after
    each epoch of ``times``.  A re-run whose scores moved in the last bits
    revises an answer in one package and not the other, so answers are
    compared as states, not as deltas."""
    live: dict = {}
    out = {}
    for t in times:
        for _t, k, d, row in (e for e in stream if e[0] == t and e[2] < 0):
            del live[k]
        for _t, k, d, row in (e for e in stream if e[0] == t and e[2] > 0):
            cells = row[1]
            live[k] = (tuple(v[1] for v in cells[2][1]), np.array([float.fromhex(v[1]) for v in cells[-1][1]]))
        out[t] = dict(live)
    return out


@pytest.mark.parametrize("metric", ["COS", "L2SQ", "IP"])
def test_device_topk_matches_jax_at_pins(metric):
    jax, port = streams(metric, "brute", n_data=320)
    a, b = jax["query_as_of_now:True"], port["query_as_of_now:True"]
    times = (2, 4, 6)
    assert {e[0] for e in a + b} <= set(times)
    a, b = states(a, times), states(b, times)
    for t, answers in a.items():
        assert answers.keys() == b[t].keys()
        for q, (names, scores) in answers.items():
            got_names, got_scores = b[t][q]
            assert len(got_names) == len(names)
            np.testing.assert_allclose(got_scores, scores, atol=SCORE_TOL, rtol=0)
            for i, (x, y) in enumerate(zip(names, got_names)):
                if x != y:  # a tie: the two rows score within the pin
                    assert abs(scores[i] - got_scores[i]) <= SCORE_TOL and y in names, (t, q, i)

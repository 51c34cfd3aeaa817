"""The port's ``pw.graphs`` held to the JAX package's.

Each program of ``tests/torch_dataflow_programs.py::graph_program``
(``pagerank`` on a seeded random graph and on a stream of edges that
grows, loses an edge and grows again; ``bellman_ford`` from one source
over seeded weighted edges in two epochs; ``louvain_level`` on two
triangles joined by one edge) runs through both packages over the port's
``iterate``; the change streams, keys, times and float bits included, are
equal on the columnar and the row path, and the port's pure-Python core
(``PATHWAY_NATIVE=0``, in a subprocess) gives the native core's.
"""

from __future__ import annotations

import pytest

import chip_smoke
import pathway_tpu as pj
import pathway_tpu_torch as pt
from tests import torch_dataflow_programs as P

PATHS = {True: "columnar", False: "row"}


@pytest.fixture(scope="module")
def python_core_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("graphs_python_core") / "deltas.pkl"
    proc = P.spawn_python_core(out, "graphs")
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def streams(python_core_run) -> dict:
    return {pw.__name__: P.capture_suite_paths(pw, "graphs") for pw in (pj, pt)}


@pytest.mark.parametrize("columnar", list(PATHS), ids=list(PATHS.values()))
@pytest.mark.parametrize("name", P.GRAPH_PROGRAMS)
def test_graph_program_matches_jax(streams, name, columnar):
    want, got = streams["pathway_tpu"][columnar][name], streams["pathway_tpu_torch"][columnar][name]
    assert sorted(got) == sorted(want)
    for table, deltas in want.items():
        assert deltas, table
        assert got[table] == deltas, table


@pytest.mark.parametrize("columnar", list(PATHS), ids=list(PATHS.values()))
@pytest.mark.parametrize("name", P.GRAPH_PROGRAMS)
def test_python_core_matches_native(streams, python_core_run, name, columnar):
    got = P.python_core_result(*python_core_run)
    assert got[columnar][name] == streams["pathway_tpu_torch"][columnar][name]


def test_incremental_pagerank_revises_to_the_static_answer(streams):
    """The growing edge stream's ranks are revised epoch by epoch and end
    at the ranks of a static run of its final graph, as in the JAX
    package's ``tests/test_graphs_iterate.py``."""
    deltas = streams["pathway_tpu_torch"][True]["pagerank"]["incremental"]
    assert any(d < 0 for _t, _k, d, _r in deltas) and len({t for t, *_ in deltas}) > 2
    final = chip_smoke.final_rows([(key, row, t, d) for t, key, d, row in deltas])
    edges = pt.debug.table_from_rows(pt.schema_from_types(u=str, v=str), [("A", "B"), ("B", "A"), ("D", "C")])
    static = P.capture(pt, {"ranks": pt.graphs.pagerank(edges, steps=50)})["ranks"]
    pt.G.clear()
    assert sorted(final.values()) == sorted(row for *_, row in static)


@pytest.mark.parametrize("module", ["pagerank", "bellman_ford"])
def test_copied_docstring_examples_run(module):
    assert P.doctest_failures(pt, f"stdlib.graphs.{module}") == 0

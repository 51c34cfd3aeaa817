"""The port's stdlib small modules held to the JAX package's.

Each program of ``tests/torch_dataflow_programs.py::stdlib_program`` (the
programs of ``tests/test_stdlib_misc.py`` for ``stateful``,
``statistical``, ``ordered`` and ``utils``, and ``ml``'s classifier,
``KNNIndex``, fuzzy match and HMM reducer, on seeded streams with several
epochs) runs in both packages; their change streams are equal, keys,
times and float bits included.
"""

from __future__ import annotations

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from tests import torch_dataflow_programs as progs

PACKAGES = (jpw, tpw)


@pytest.fixture(autouse=True)
def clean_graphs():
    for pw in PACKAGES:
        pw.G.clear()
    yield
    for pw in PACKAGES:
        pw.G.clear()


@pytest.mark.parametrize("name", progs.STDLIB_PROGRAMS)
def test_stdlib_program_matches_jax(name):
    jax, port = (progs.capture(pw, progs.stdlib_program(pw, name)) for pw in PACKAGES)
    assert all(jax.values()), {k: len(v) for k, v in jax.items()}
    assert port == jax


def test_deduplicate_and_diff_revise_their_rows():
    """The streams carry retractions: a later accepted value replaces the
    kept one, and a row inserted between two others changes their diff."""
    port = progs.capture(tpw, progs.stdlib_program(tpw, "deduplicate"))
    assert any(d < 0 for _t, _k, d, _r in port["latest"])
    port = progs.capture(tpw, progs.stdlib_program(tpw, "diff"))
    assert {t for t, _k, _d, _r in port["instance"]} > {2}


DOCTESTED = ("stateful", "statistical", "ordered", "utils.async_transformer")


@pytest.mark.parametrize("module", DOCTESTED)
def test_copied_docstring_examples_run(module):
    """The ``>>>`` examples the port's stdlib modules carry over from the
    JAX package's (which ``tests/test_doctests.py`` runs there) run here."""
    assert progs.doctest_failures(tpw, f"stdlib.{module}") == 0

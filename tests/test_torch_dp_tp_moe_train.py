"""The port's data- and tensor-parallel causal-LM step on the MoE decoder
(``pw-tiny-moe-decoder``) across a gloo world of 4 (``make_mesh`` gives
``(2, 2)``: experts over ``model``, and the MoE layers gather the tokens
over ``data`` so that routing and capacity follow the global token
order), against the JAX package's step on ``make_mesh(4)``.

The fixtures and pins are ``tests/test_torch_dp_tp_train.py``'s: a tree
drawn once from a seed and given to both packages as numpy, step-0
gradients at relative L2 1e-4 leaf for leaf (JAX's read from its first
Adam moment) and the losses of 3 Adam steps at 1e-4 relative.
"""

from __future__ import annotations

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.test_torch_dp_tp_train import (  # noqa: E402
    check_lm_grads,
    check_lm_losses,
    jax_lm_reference,
    lm_groups,
    lm_inputs,
)

DECODER = "pw-tiny-moe-decoder"
WORLD = 4


@pytest.fixture(scope="module")
def inputs():
    return lm_inputs(DECODER)


@pytest.fixture(scope="module")
def groups(tmp_path_factory, inputs):
    started = lm_groups(tmp_path_factory, inputs, (WORLD,))
    yield started
    for group in started.values():
        group.stop()


@pytest.fixture(scope="module")
def want(inputs):
    return jax_lm_reference(inputs)


@pytest.fixture(scope="module")
def ranks(groups, want):
    """The ranks' results, waited for after JAX's (computed meanwhile)."""
    return groups[WORLD].results()


def test_moe_lm_mesh_grads_match_jax(ranks, want):
    check_lm_grads(ranks, want, DECODER, (2, 2))


def test_moe_lm_mesh_losses_match_jax(ranks, want):
    check_lm_losses(ranks, want, DECODER)

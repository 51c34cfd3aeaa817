"""The port's data- and tensor-parallel causal-LM train step
(``parallel/train.py``'s ``make_lm_step_runner`` and
``make_causal_lm_train_step`` with ``mesh=``) across gloo ranks, against
the JAX package's step on a mesh (the conftest's virtual CPU devices).

One gloo group per world size (``tests/gloo_model_ranks.py``): at world 2
``make_mesh`` gives ``(1, 2)``, at world 4 ``(2, 2)``; each trains
``pw-tiny-decoder`` from a tree drawn once from a seed and given to both
packages as numpy, placed by ``tp_param_specs``.
The JAX step runs on ``make_mesh(4)`` (its math does not depend on the
mesh), and its step-0 gradient is read from its first Adam moment.
Step-0 gradients are compared directly, leaf for leaf, so a constant
factor from a collective's backward fails: relative L2 1e-4
(``tests/test_torch_lm_train.py:111-113``); the losses of 3 Adam steps at
1e-4 relative, as that file holds them.
``tests/test_torch_dp_tp_moe_train.py`` holds the MoE decoder's step at
world 4 (its layers gather the tokens over ``data``) and
``tests/test_torch_dp_contrastive.py`` the contrastive step, each in a
file of its own to keep a file near 30 s.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import optax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from pathway_tpu.models import decoder as jdec  # noqa: E402
from pathway_tpu.parallel import make_mesh  # noqa: E402
from pathway_tpu.parallel import train as jtrain  # noqa: E402
from pathway_tpu_torch.models import decoder as tdec  # noqa: E402
from tests import gloo_model_ranks as gm  # noqa: E402
from tests import gloo_ranks as g  # noqa: E402

DECODER = "pw-tiny-decoder"
LR = gm.LR
GRAD_TOL, LOSS_TOL = 1e-4, 1e-4  # relative L2; relative
WORLDS = (2, 4)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def flat(tree, prefix="", sep="/") -> dict:
    """``{path: numpy}`` of a nested tree, keys sorted at every level."""
    out = {}
    for key in sorted(tree):
        name = f"{prefix}{key}"
        if hasattr(tree[key], "items"):
            out.update(flat(tree[key], name + sep, sep))
        else:
            out[name] = np.asarray(tree[key], np.float32)
    return out


def first_grads(opt_state, b1: float = 0.9):
    """The gradient of a JAX step's first Adam update, read from its first
    moment (``mu = (1 - b1) · g`` after one step): the mesh step's own
    gradient, without a second compile."""
    return jax.tree_util.tree_map(lambda m: np.asarray(m, np.float32) / np.float32(1 - b1),
                                  jax.device_get(opt_state[0].mu))


def lm_inputs(name: str):
    """One seeded tree of decoder ``name`` (numpy) and a batch."""
    ids = np.random.default_rng(6).integers(1, 512, size=(4, 12))
    return {name: gm.seeded_decoder_tree(tdec.decoder_config_for(name), 3)}, ids, np.array([12, 9, 7, 2])


def lm_groups(tmp_path_factory, inputs, worlds):
    return {w: g.RankGroup(gm.lm_mesh_case, w, tmp_path_factory.mktemp(f"dptp{w}"), *inputs) for w in worlds}


def jax_lm_reference(inputs) -> dict:
    """JAX's mesh step on ``make_mesh(4)``: the losses of 3 Adam steps and
    the first's gradient, for each tree."""
    trees, ids, lens = inputs
    mesh = make_mesh(4)
    out = {}
    for name, tree in trees.items():
        cfg = jdec.decoder_config_for(name)
        _, run = jtrain.make_causal_lm_train_step(cfg, optax.adam(LR), mesh)
        placed = jax.tree_util.tree_map(lambda t, s: jax.device_put(t, NamedSharding(mesh, s)), tree,
                                        jdec.tp_param_specs(cfg))
        state = jtrain.TrainState(params=placed, opt_state=optax.adam(LR).init(placed))
        out[name] = dict(losses=[])
        for i in range(3):
            state, loss = run(state, ids, lens)
            out[name]["losses"].append(float(loss))
            if i == 0:
                out[name]["grads"] = flat(first_grads(state.opt_state))
    return out


def check_lm_grads(ranks, want, name: str, shape: tuple) -> None:
    """Every rank's mesh and step-0 gradients, leaf for leaf, against JAX's."""
    jg = want[name]["grads"]
    for res in ranks:
        assert res["shape"] == shape
        assert res["both"].startswith("ValueError") and "not both" in res["both"]
        assert sorted(res[name]["grads"]) == sorted(jg)
        for leaf, grad in res[name]["grads"].items():
            assert rel_l2(grad, jg[leaf]) < GRAD_TOL, leaf


def check_lm_losses(ranks, want, name: str) -> None:
    """Every rank's 3 losses against JAX's, falling."""
    for res in ranks:
        r = res[name]
        np.testing.assert_allclose(r["losses"], want[name]["losses"], rtol=LOSS_TOL)
        assert r["losses"][-1] < r["losses"][0] and r["step"] == 3


@pytest.fixture(scope="module")
def inputs():
    return lm_inputs(DECODER)


@pytest.fixture(scope="module")
def groups(tmp_path_factory, inputs):
    started = lm_groups(tmp_path_factory, inputs, WORLDS)
    yield started
    for group in started.values():
        group.stop()


@pytest.fixture(scope="module")
def want(inputs):
    return jax_lm_reference(inputs)


@pytest.fixture(scope="module")
def all_ranks(groups, want):
    """Every group's results, waited for after JAX's (computed meanwhile)."""
    return {w: groups[w].results() for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_lm_mesh_grads_match_jax(all_ranks, want, world):
    check_lm_grads(all_ranks[world], want, DECODER, {2: (1, 2), 4: (2, 2)}[world])


@pytest.mark.parametrize("world", WORLDS)
def test_lm_mesh_losses_match_jax(all_ranks, want, world):
    check_lm_losses(all_ranks[world], want, DECODER)

"""The port's expert parallelism (``parallel/moe.py``: ``ep_param_specs``,
``make_ep_mesh``, ``moe_ffn(..., mesh)`` and ``make_moe_train_step(...,
mesh=...)``) across gloo ranks, against the JAX package.

The spec tree is compared with JAX's in the pytest process.  One gloo
group per world size (``tests/gloo_model_ranks.py``): ``moe_ffn`` at
``tests/test_moe.py:53-67``'s config on ``make_ep_mesh(2)`` ``(1, 2)`` and
``make_ep_mesh(4)`` ``(1, 4)``, and at world 4 on ``(2, 2)`` with each
rank's rows of the tokens, against JAX's unsharded layer at 1e-5, aux
included (``test_moe.py:66-67``); and the EP train step at ``(2, 2)``
against JAX's ``make_ep_mesh(4, expert_parallel=2)`` step
(``test_moe.py:90-104``): losses of 3 Adam steps and step-0 gradients at
1e-5.  Weights are drawn once from a seed and given to both packages as
numpy.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from pathway_tpu.parallel import moe as jmoe  # noqa: E402
from pathway_tpu_torch.parallel import moe as tmoe  # noqa: E402
from tests import gloo_model_ranks as gm  # noqa: E402
from tests import gloo_ranks as g  # noqa: E402
from tests.test_torch_dp_tp_train import first_grads, rel_l2  # noqa: E402

FFN_CFG = dict(hidden=8, experts=8, intermediate=16, top_k=2)  # tests/test_moe.py:54
TRAIN_CFG = dict(hidden=8, experts=4, intermediate=16, top_k=2)  # :91
TOL = 1e-5
STEPS = 3
WORLDS = (2, 4)


def _params(cfg: dict, seed: int) -> dict:
    return gm.numpy_tree(tmoe.init_moe_params(tmoe.MoEConfig(**cfg), seed, device="cpu"))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    ffn = (FFN_CFG, _params(FFN_CFG, 2), rng.normal(size=(32, 8)).astype(np.float32))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    target = np.tanh(x @ rng.normal(size=(8, 8)).astype(np.float32))
    return ffn, (TRAIN_CFG, _params(TRAIN_CFG, 0), x, target, STEPS)


@pytest.fixture(scope="module")
def groups(tmp_path_factory, inputs):
    ffn, train = inputs
    started = {w: g.RankGroup(gm.moe_ep_cases, w, tmp_path_factory.mktemp(f"ep{w}"), ffn, train if w == 4 else None)
               for w in WORLDS}
    yield started
    for group in started.values():
        group.stop()


@pytest.fixture(scope="module")
def want(inputs):
    (cfg, params, x), (tcfg, tparams, tx, target, steps) = inputs
    y, aux = jmoe.moe_ffn(params, jnp.asarray(x), jmoe.MoEConfig(**cfg))
    mesh = jmoe.make_ep_mesh(4, expert_parallel=2)  # ("data", "expert") = (2, 2)
    _, step_fn = jmoe.make_moe_train_step(jmoe.MoEConfig(**tcfg), optax.adam(gm.LR), mesh)
    p = jax.tree_util.tree_map(lambda t, s: jax.device_put(t, NamedSharding(mesh, s)), tparams,
                               jmoe.ep_param_specs())
    o = optax.adam(gm.LR).init(p)
    losses = []
    for i in range(steps):
        p, o, loss = step_fn(p, o, tx, target)
        losses.append(float(loss))
        if i == 0:
            grads = first_grads(o)
    return dict(y=np.asarray(y), aux=float(aux), losses=losses, grads=grads)


@pytest.fixture(scope="module")
def all_ranks(groups, want):
    """Every group's results, waited for after JAX's (computed meanwhile)."""
    return {w: groups[w].results() for w in WORLDS}


def test_ep_param_specs_match_jax():
    for axis in ("expert", "model"):
        assert tmoe.ep_param_specs(axis) == {k: tuple(v) for k, v in jmoe.ep_param_specs(axis).items()}


@pytest.mark.parametrize("w,key", [(2, "all_expert"), (4, "all_expert"), (4, "data_expert")])
def test_ep_moe_ffn_matches_jax_unsharded(all_ranks, want, w, key):
    for res in all_ranks[w]:
        r = res[key]
        n_data = r["shape"][0]
        assert r["shape"] == {"all_expert": (1, w), "data_expert": (2, 2)}[key]
        rows = np.split(want["y"], n_data)[r["data"]]
        np.testing.assert_allclose(r["y"], rows, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["aux"], want["aux"], rtol=TOL)


@pytest.mark.parametrize("w", WORLDS)
def test_make_ep_mesh_covers_the_world(all_ranks, w):
    for res in all_ranks[w]:
        assert res["world"].startswith("ValueError") and "world of" in res["world"]


def test_ep_train_step_matches_jax(all_ranks, want):
    for res in all_ranks[4]:
        r = res["train"]
        assert r["local"] == (TRAIN_CFG["experts"] // 2, 8, 16)  # two experts a rank
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=TOL)
        assert r["losses"][-1] < r["losses"][0]
        for name, grad in r["grads"].items():
            assert rel_l2(grad, want["grads"][name]) < TOL, name
            assert np.abs(grad).max() > 0, name

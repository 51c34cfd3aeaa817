"""The port's GPipe pipeline (``parallel/pipeline.py``) across gloo
ranks, against the JAX package's.

One gloo group per stage count (``tests/gloo_model_ranks.py``), at 2 and 4
stages; trees drawn once from a seed and given to both packages as numpy.
Pins (``tests/test_pipeline.py``, ``tests/test_remat.py``):

* the pipelined logits against JAX's ``causal_lm_logits`` at 2e-4
  (``test_pipeline.py:47,62,83``): ``n_micro`` 4, ``n_micro`` 1, the MoE
  config with ample capacity (2 stages: its 2 layers), and ``remat``
  (``test_remat.py:67``, 2 stages), whose step-0 gradients equal the plain
  forward's;
* ``make_pp_train_step``'s losses over 3 Adam steps against JAX's at
  rtol 1e-4 (``test_pipeline.py:108``); JAX's step runs at 4 stages (its
  math does not depend on the stage count);
* its step-0 gradients, leaf for leaf, against the port's unpipelined
  step's on the same tree and batch (relative L2 1e-5: the same f32
  math, summed in another order) and against JAX's pipelined step's,
  read from its first Adam moment (1e-4, the decoder gradient pin).
  Adam hides a constant factor on a gradient, so the gradients are
  compared directly: a factor from a collective's backward (the
  broadcast's, the rotation's) fails.
* MoE training under pp raises ``NotImplementedError`` with JAX's message.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from pathway_tpu.models import decoder as jdec  # noqa: E402
from pathway_tpu.parallel import pipeline as jpp  # noqa: E402
from pathway_tpu.parallel import train as jtrain  # noqa: E402
from pathway_tpu_torch.models import decoder as tdec  # noqa: E402
from pathway_tpu_torch.parallel import pipeline as tpp  # noqa: E402
from tests import gloo_model_ranks as gm  # noqa: E402
from tests import gloo_ranks as g  # noqa: E402
from tests.test_torch_dp_tp_train import first_grads, flat, rel_l2  # noqa: E402

CFG = dict(vocab_size=128, hidden=32, layers=4, heads=4, kv_heads=2, intermediate=64, max_len=64)  # test_pipeline.py:27
MOE = dict(CFG, layers=2, experts=4, expert_capacity_factor=16.0)  # :68-69
REMAT = dict(vocab_size=512, hidden=64, layers=2, heads=4, kv_heads=2, intermediate=128, max_len=128,
             remat=True)  # test_remat.py:21, pw-tiny-decoder
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_TOL, GRAD_TOL, PLAIN_TOL = 1e-4, 1e-4, 1e-5
WORLDS = (2, 4)
JAX_STAGES = 4


def _tree(fields: dict, seed: int):
    return gm.seeded_decoder_tree(tdec.DecoderConfig(**fields, dtype=torch.float32), seed)


def _batch(rng, vocab, b=8, s=12):  # test_pipeline.py:33-36
    ids = rng.integers(1, vocab, size=(b, s)).astype(np.int32)
    return ids, rng.integers(s // 2, s + 1, size=(b,)).astype(np.int32)


@pytest.fixture(scope="module")
def inputs():
    forwards = {
        "micro4": (CFG, _tree(CFG, 0), *_batch(np.random.default_rng(0), 128), 4),
        "micro1": (CFG, _tree(CFG, 1), *_batch(np.random.default_rng(1), 128, b=3, s=9), 1),
        "moe": (MOE, _tree(MOE, 5), *_batch(np.random.default_rng(5), 128, b=4, s=8), 2),
        "remat": (REMAT, _tree(REMAT, 2), np.random.default_rng(2).integers(1, 512, size=(4, 8)).astype(np.int32),
                  np.full((4,), 8, np.int32), 2),
    }
    training = (CFG, _tree(CFG, 0), *_batch(np.random.default_rng(2), 128), 2)
    return forwards, training


def _forwards_at(forwards, world):
    """Every forward case whose layers split into ``world`` stages."""
    return {k: v for k, v in forwards.items() if v[0]["layers"] % world == 0}


@pytest.fixture(scope="module")
def groups(tmp_path_factory, inputs):
    forwards, training = inputs
    started = {w: g.RankGroup(gm.pipeline_cases, w, tmp_path_factory.mktemp(f"pp{w}"), _forwards_at(forwards, w),
                              training) for w in WORLDS}
    yield started
    for group in started.values():
        group.stop()


def _jcfg(fields):
    return jdec.DecoderConfig(**fields, dtype=jnp.float32)


@pytest.fixture(scope="module")
def want(inputs):
    """JAX's unpipelined logits of each forward case, and its pipelined
    train step at ``JAX_STAGES`` stages: losses and first gradients."""
    forwards, (fields, tree, ids, lens, n_micro) = inputs
    out = {"logits": {k: np.asarray(jdec.causal_lm_logits(t, jnp.asarray(i), jnp.asarray(n), _jcfg(f)))
                      for k, (f, t, i, n, _) in forwards.items()}}
    mesh = jpp.make_pp_mesh(JAX_STAGES)
    _, run = jpp.make_pp_train_step(_jcfg(fields), optax.adam(gm.LR), mesh, n_micro)
    placed = jpp.place_pp_params(tree, mesh)
    state = jtrain.TrainState(params=placed, opt_state=optax.adam(gm.LR).init(placed))
    out["losses"] = []
    for i in range(3):
        state, loss = run(state, ids, lens)
        out["losses"].append(float(loss))
        if i == 0:
            out["grads"] = flat(first_grads(state.opt_state))
    return out


@pytest.fixture(scope="module")
def all_ranks(groups, want):
    """Every group's results, waited for after JAX's (computed meanwhile)."""
    return {w: groups[w].results() for w in WORLDS}


def test_pp_param_specs_and_stacking_match_jax():
    tree = _tree(CFG, 0)
    stacked = tpp.stack_stages({k: (torch.from_numpy(v) if not isinstance(v, dict) else
                                    {kk: torch.from_numpy(vv) for kk, vv in v.items()}) for k, v in tree.items()}, 2)
    jstacked = jpp.stack_stages(tree, 2)
    for name, leaf in stacked["layers"].items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jstacked["layers"][name]))
    jspecs = jpp.pp_param_specs(jstacked)
    specs = tpp.pp_param_specs(stacked)
    assert {k: v for k, v in specs.items() if k != "layers"} == {k: tuple(v) for k, v in jspecs.items() if k != "layers"}
    assert specs["layers"] == {k: tuple(v) for k, v in jspecs["layers"].items()}
    with pytest.raises(ValueError, match="do not split"):
        tpp.stack_stages(stacked, 3)


@pytest.mark.parametrize("w,key", [(w, k) for w in WORLDS for k in ("micro4", "micro1", "moe", "remat")
                                   if dict(micro4=CFG, micro1=CFG, moe=MOE, remat=REMAT)[k]["layers"] % w == 0])
def test_pipelined_logits_match_jax(all_ranks, want, w, key):
    for res in all_ranks[w]:
        r = res[key]
        assert r["local_layers"][0] == 1  # each rank holds its own stage
        np.testing.assert_allclose(r["logits"], want["logits"][key], **LOGIT_TOL)


def test_remat_pipeline_gives_the_plain_gradients(all_ranks):
    for res in all_ranks[2]:
        grads = res["remat"]["remat_grads"]
        for name, grad in grads[False].items():
            np.testing.assert_array_equal(grads[True][name], grad, err_msg=name)


@pytest.mark.parametrize("w", WORLDS)
def test_pp_train_losses_match_jax(all_ranks, want, w):
    for res in all_ranks[w]:
        r = res["train"]
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=LOSS_TOL)
        np.testing.assert_allclose(r["losses"][0], r["plain_loss"], rtol=LOSS_TOL)
        assert r["losses"][-1] < r["losses"][0] and r["step"] == 3
        assert res["world"].startswith("ValueError")


@pytest.mark.parametrize("w", WORLDS)
def test_pp_grads_are_the_unpipelined_grads(all_ranks, want, w):
    for res in all_ranks[w]:
        got, plain = res["train"]["grads"], res["train"]["plain_grads"]
        assert sorted(got) == sorted(plain) == sorted(want["grads"])
        for name, grad in got.items():
            grad = grad.reshape(plain[name].shape)
            assert rel_l2(grad, plain[name]) < PLAIN_TOL, name
            assert rel_l2(grad, want["grads"][name].reshape(grad.shape)) < GRAD_TOL, name


def test_pp_moe_training_is_refused_as_in_jax():
    moe = tdec.DecoderConfig(**MOE, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="aux") as port:
        tpp.make_pp_train_step(moe, None, None, n_micro=2)
    with pytest.raises(NotImplementedError) as ref:
        jpp.make_pp_train_step(_jcfg(MOE), optax.adam(1e-2), None, n_micro=2)
    assert str(port.value) == str(ref.value)

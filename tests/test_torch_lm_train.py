"""The port's causal-LM training forward and step (``models/decoder.py``'s
``causal_lm_logits_and_aux`` and ``remat``, ``parallel/train.py``'s
``make_causal_lm_train_step``) against the JAX package's.

``pw-tiny-decoder`` and ``pw-tiny-moe-decoder`` in f32, the JAX tree
carried across through numpy, the port on the CPU.  Pins: logits and aux
at the decoder pin 2e-4; one step's loss and per-leaf gradients at
relative L2 1e-4 and the tree after it within 0.1·lr (2·lr where a
gradient is under 1e-3 of its leaf's largest, whose sign the rounding can
flip); remat on against off bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from pathway_tpu.models import decoder as jdec  # noqa: E402
from pathway_tpu.parallel import make_mesh  # noqa: E402
from pathway_tpu.parallel import train as jtrain  # noqa: E402
from pathway_tpu_torch.models import decoder as tdec  # noqa: E402
from pathway_tpu_torch.parallel import train as ttrain  # noqa: E402

DECODER_TOL = dict(rtol=2e-4, atol=2e-4)
DECODERS = ("pw-tiny-decoder", "pw-tiny-moe-decoder")
LR = 1e-2


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def adam(lr=LR):
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@pytest.fixture(scope="module", params=DECODERS)
def decoder(request):
    """(JAX config, port config, JAX tree (numpy), port tree, the JAX
    package's ``make_causal_lm_train_step`` run and its step-0 state on
    the mesh holding that tree), f32."""
    jcfg, tcfg = jdec.decoder_config_for(request.param), tdec.decoder_config_for(request.param)
    mesh = make_mesh(8)
    _, j_run = jtrain.make_causal_lm_train_step(jcfg, optax.adam(LR), mesh)
    # its init_state (parallel/train.py:171-177), with the init jitted
    tree = jax.jit(jdec.init_decoder_params, static_argnums=(0, 1))(jcfg, 3)
    tree = jax.tree_util.tree_map(lambda t, s: jax.device_put(t, NamedSharding(mesh, s)), tree,
                                  jdec.tp_param_specs(jcfg))
    jstate = jtrain.TrainState(params=tree, opt_state=optax.adam(LR).init(tree))
    jtree = jax.device_get(tree)
    return jcfg, tcfg, jtree, tdec.from_jax_decoder_params(jtree, tcfg, "cpu"), j_run, jstate


def _lm_batch(rng, cfg, B=4, S=12):
    ids = rng.integers(1, cfg.vocab_size, size=(B, S))
    lens = np.array([S, S - 3, 7, 2][:B])
    return ids, lens


def port_grads(tree) -> dict:
    return {name: t.grad.numpy() for name, t in ttrain.named_leaves(tree).items()}


def jax_leaves(tree) -> dict:
    return {name: np.asarray(x, np.float32) for name, x in ttrain.named_leaves(jax.device_get(tree)).items()}


def test_causal_lm_logits_and_aux_match_jax(decoder):
    jcfg, tcfg, jtree, ttree, _, _ = decoder
    ids, lens = _lm_batch(np.random.default_rng(5), jcfg)
    jl, jaux = jdec.causal_lm_logits_and_aux(jtree, jnp.asarray(ids), jnp.asarray(lens), jcfg)
    tl, taux = tdec.causal_lm_logits_and_aux(ttree, torch.from_numpy(ids), torch.from_numpy(lens), tcfg)
    assert tl.shape == (4, 12, tcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DECODER_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **DECODER_TOL)
    if not tcfg.experts:
        assert float(taux) == 0.0
    torch.testing.assert_close(tdec.causal_lm_logits(ttree, torch.from_numpy(ids), torch.from_numpy(lens), tcfg),
                               tl, rtol=0, atol=0)


def test_causal_lm_train_step_matches_jax(decoder):
    """One ``make_causal_lm_train_step`` step: its loss and the gradients
    of every leaf against ``jax.value_and_grad`` of the JAX step's loss,
    and the updated tree against the JAX step's."""
    jcfg, tcfg, jtree, _, j_run, jstate = decoder
    ids, lens = _lm_batch(np.random.default_rng(6), jcfg)

    def loss_fn(tree):  # parallel/train.py:125-128
        logits, aux = jdec.causal_lm_logits_and_aux(tree, jnp.asarray(ids), jnp.asarray(lens), jcfg)
        return jtrain.masked_next_token_loss(logits, jnp.asarray(ids), jnp.asarray(lens)) + 0.01 * aux

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jtree)
    jstate, jstep_loss = j_run(jstate, ids, lens)

    tree = tdec.from_jax_decoder_params(jtree, tcfg, "cpu")
    state = ttrain.train_state(tree, adam(LR))
    tloss = ttrain.lm_loss(state.params, torch.from_numpy(ids), torch.from_numpy(lens), tcfg)
    tloss.backward()
    got, want = port_grads(state.params), jax_leaves(jgrads)
    assert rel_l2(float(tloss.detach()), float(jloss)) < 1e-4
    for name in want:
        assert rel_l2(got[name], want[name]) < 1e-4, name
    state.opt_state.zero_grad(set_to_none=True)
    _, run = ttrain.make_causal_lm_train_step(tcfg, adam(LR), device="cpu")
    state, step_loss = run(state, ids, lens)
    assert state.step == 1
    np.testing.assert_allclose(float(step_loss), float(jstep_loss), rtol=1e-4)
    after = jax_leaves(jstate.params)
    for name, t in ttrain.named_leaves(state.params).items():
        # Adam's first step is lr·g/(|g| + eps): insensitive to the
        # gradient's rounding but where |g| is so small against the leaf's
        # gradients that the rounding can flip its sign (then ±lr)
        g = np.abs(want[name])
        atol = np.where(g > 1e-3 * g.max(), 0.1 * LR, 2 * LR)
        diff = np.abs(t.detach().numpy() - after[name])
        assert (diff <= atol).all(), (name, float(diff.max()))


@pytest.mark.parametrize("name", DECODERS)
def test_remat_gives_the_same_loss_and_grads(name):
    cfg = tdec.decoder_config_for(name)
    ids, lens = _lm_batch(np.random.default_rng(7), cfg)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        state = ttrain.train_state(tdec.init_decoder_params(c, 4, device="cpu"), adam())
        loss = ttrain.lm_loss(state.params, torch.from_numpy(ids), torch.from_numpy(lens), c)
        loss.backward()
        out[remat] = float(loss.detach()), port_grads(state.params)
    assert out[True][0] == out[False][0]
    for leaf, g in out[False][1].items():
        np.testing.assert_array_equal(out[True][1][leaf], g, err_msg=leaf)


def test_training_forward_makes_no_cache():
    cfg = tdec.decoder_config_for("pw-tiny-decoder")
    tree = tdec.init_decoder_params(cfg, 0, device="cpu")
    ids = torch.randint(1, cfg.vocab_size, (2, 9))
    x, kc, vc, aux = tdec._causal_trunk(tree, ids, torch.tensor([9, 4]), cfg, None)
    assert kc is None and vc is None and aux == 0.0 and x.shape == (2, 9, cfg.hidden)
    # the serving trunk still fills its caches, with the same reps
    xs, kc, vc, _ = tdec._causal_trunk(tree, ids, torch.tensor([9, 4]), cfg, 16)
    assert kc.shape == (cfg.layers, 2, 16, cfg.kv_heads, cfg.head_dim)
    torch.testing.assert_close(xs, x, rtol=0, atol=0)

"""The port's training step (``parallel/train.py``) against the JAX
package's: the contrastive encoder step, ``optax.adam`` against
``torch.optim.Adam``, and the masked next-token loss
(``tests/test_torch_lm_train.py`` holds the causal-LM step).

The contrastive step runs at ``tests/test_parallel.py:94-117``'s config
with ``dtype=float32``; the JAX tree is carried across through numpy, and
the port runs on the CPU.  Pins: step-0 loss and per-leaf gradients at
relative L2 1e-5, losses over 3 Adam steps at 1e-5 relative, params after
them within 0.1·lr absolute (Adam's first step normalises a near-zero
gradient, so its rounding moves a param by up to lr), Adam on identical
gradients at relative L2 1e-6, the masked loss at 1e-6 relative.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from pathway_tpu.models import encoder as jenc  # noqa: E402
from pathway_tpu.parallel import make_contrastive_train_step as j_contrastive_step  # noqa: E402
from pathway_tpu.parallel import make_mesh, shard_params  # noqa: E402
from pathway_tpu.parallel import train as jtrain  # noqa: E402
from pathway_tpu_torch.models import encoder as tenc  # noqa: E402
from pathway_tpu_torch.parallel import train as ttrain  # noqa: E402

LR = 1e-3
ENCODER = dict(vocab_size=256, hidden=32, layers=1, heads=2, intermediate=64, max_len=32)  # test_parallel.py:100-102


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def flat_jax(tree, prefix="") -> dict:
    """``{path: numpy}`` of a JAX tree, paths as the port's state names."""
    out = {}
    for key in sorted(tree):
        name = f"{prefix}{key}"
        if hasattr(tree[key], "items"):
            out.update(flat_jax(tree[key], name + "."))
        else:
            out[name] = np.asarray(tree[key], np.float32)
    return out


def adam(lr=LR):
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999), eps=1e-8)


# ---------------------------------------------------------------------------
# the contrastive encoder step
# ---------------------------------------------------------------------------


def _batch(rng, n=16, s=8):
    ids_a = rng.integers(1, 256, size=(n, s)).astype(np.int32)
    ids_b = rng.integers(1, 256, size=(n, s)).astype(np.int32)
    mask = np.ones((n, s), np.int32)
    mask[::3, s // 2:] = 0  # some padded rows: the masks reach pooling and attention
    return ids_a, mask, ids_b, mask


@pytest.fixture(scope="module")
def contrastive():
    """(JAX module, JAX step, JAX state, port module, port state) over the
    same f32 weights."""
    jcfg = jenc.EncoderConfig(**ENCODER, dtype=jnp.float32)
    tcfg = tenc.EncoderConfig(**ENCODER, dtype=torch.float32)
    jmod = jenc.SentenceEncoderModule(jcfg)
    mesh = make_mesh(8)
    # init_train_state (parallel/train.py:38-51) with the init jitted
    dummy = jnp.zeros((1, 8), jnp.int32)
    params = shard_params(jax.jit(jmod.init)(jax.random.PRNGKey(0), dummy, dummy + 1), mesh)
    jstate = jtrain.TrainState(params=params, opt_state=optax.adam(LR).init(params))
    jstep = j_contrastive_step(jmod, optax.adam(LR), mesh)
    params = jax.device_get(jstate.params)
    tmod = tenc.SentenceEncoderModule(tcfg, params, device="cpu")
    tstate, _ = ttrain.init_train_state(tmod, adam(), device="cpu")
    return jmod, jstep, jstate, tmod, tstate


def test_contrastive_state_holds_the_jax_tree(contrastive):
    _, _, jstate, _, tstate = contrastive
    want = flat_jax(jax.device_get(jstate.params)["params"])
    got = {name: t.detach().numpy() for name, t in tstate.params.items()}
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
        assert tstate.params[name].requires_grad
    assert tstate.step == 0


def test_contrastive_loss_and_grads_match_jax(contrastive):
    jmod, _, jstate, tmod, tstate = contrastive
    batch = _batch(np.random.default_rng(0))

    def loss_fn(params, ids_a, mask_a, ids_b, mask_b):  # parallel/train.py:69-76
        za = jmod.apply(params, ids_a, mask_a)
        zb = jmod.apply(params, ids_b, mask_b)
        logits = (za @ zb.T) / 0.05
        labels = jnp.arange(logits.shape[0])
        l_ab = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        l_ba = optax.softmax_cross_entropy_with_integer_labels(logits.T, labels)
        return 0.5 * (jnp.mean(l_ab) + jnp.mean(l_ba))

    jparams = jax.device_get(jstate.params)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams, *map(jnp.asarray, batch))
    tbatch = [torch.from_numpy(x.astype(np.int64)) for x in batch]
    tloss = ttrain.contrastive_loss(tmod, tstate.params, *tbatch)
    names = sorted(tstate.params)
    tgrads = dict(zip(names, torch.autograd.grad(tloss, [tstate.params[n] for n in names])))
    assert rel_l2(float(tloss.detach()), float(jloss)) < 1e-5
    want = flat_jax(jax.device_get(jgrads)["params"])
    total = np.sqrt(sum(np.square(w).sum() for w in want.values()))
    for name, g in tgrads.items():
        if name.endswith("key.bias"):
            # softmax over keys is invariant to the key bias (it adds q·b
            # to every key of a query): both gradients are rounding noise
            assert max(np.linalg.norm(g.numpy()), np.linalg.norm(want[name])) < 1e-6 * total, name
        else:
            assert rel_l2(g.numpy(), want[name]) < 1e-5, name


def test_contrastive_adam_steps_match_jax(contrastive):
    _, jstep, jstate, tmod, tstate = contrastive
    tstate = ttrain.train_state({n: t.detach().clone() for n, t in tstate.params.items()}, adam())
    step = ttrain.make_contrastive_train_step(tmod, device="cpu")
    batch = _batch(np.random.default_rng(1))
    jl, tl = [], []
    for _ in range(3):
        jstate, loss = jstep(jstate, *batch)
        jl.append(float(loss))
        tstate, loss = step(tstate, *batch)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0] and tstate.step == jstate.step == 3
    want = flat_jax(jax.device_get(jstate.params)["params"])
    for name, t in tstate.params.items():
        # the key bias's gradient is rounding noise (see above), which Adam
        # normalises to a step of ±lr either way: it stays within 3 steps
        atol = 2 * 3 * LR if name.endswith("key.bias") else 0.1 * LR
        np.testing.assert_allclose(t.detach().numpy(), want[name], rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("lr,shape", [(1e-3, (7, 5)), (1e-2, (33,)), (3e-4, (4, 3, 2))])
def test_torch_adam_matches_optax_adam(lr, shape):
    """Identical gradient sequences through ``optax.adam(lr)`` and
    ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, f32."""
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=shape).astype(np.float32)
    grads = [rng.normal(size=shape).astype(np.float32) * s for s in (1.0, 0.1, 3.0, 1e-3, 0.5, 2.0)]
    opt = optax.adam(lr)
    jp, js = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.tensor(p0, requires_grad=True)
    topt = adam(lr)([tp])
    for g in grads:
        updates, js = opt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        topt.step()
        assert rel_l2(tp.detach().numpy(), jp) < 1e-6
    for name, j in (("exp_avg", js[0].mu), ("exp_avg_sq", js[0].nu)):
        assert rel_l2(topt.state[tp][name].numpy(), j) < 1e-6, name


@pytest.mark.parametrize("lengths", [(12, 12, 12), (12, 5, 1)])
def test_masked_next_token_loss_matches_jax(lengths):
    rng = np.random.default_rng(4)
    B, S, V = 3, 12, 50
    logits = (rng.normal(size=(B, S, V)) * 3).astype(np.float32)
    ids = rng.integers(0, V, size=(B, S))
    lens = np.asarray(lengths)
    want = float(jtrain.masked_next_token_loss(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(lens)))
    got = float(ttrain.masked_next_token_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                                              torch.from_numpy(lens)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)



"""The port's MoE training (``parallel/moe.py::make_moe_train_step``, and
the gradient of ``moe_ffn`` through routing, capacity dropping and the aux
loss) against the JAX package's (``tests/test_moe.py:90-104``'s run).

The JAX step runs expert-parallel on the conftest's 8 CPU devices
(``make_ep_mesh(8, expert_parallel=4)``); the port runs on the CPU with
the same weights (carried across through numpy) and data.  Pins: the
losses over 10 Adam steps at 1e-4 relative; the loss and per-leaf
gradients at relative L2 1e-5 (``tests/test_moe.py``'s pin); an int8
tree raises.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from pathway_tpu.parallel import moe as jmoe  # noqa: E402
from pathway_tpu_torch.models import decoder as tdec  # noqa: E402
from pathway_tpu_torch.parallel import moe as tmoe  # noqa: E402

LR = 1e-2
CFG = dict(hidden=8, experts=4, intermediate=16, top_k=2)


def adam(lr=LR):
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _data(seed=0, n=64, h=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h)).astype(np.float32)
    return x, np.tanh(x @ rng.normal(size=(h, h)).astype(np.float32))


def _into(params, jparams):
    with torch.no_grad():
        for name, t in params.items():
            t.copy_(torch.from_numpy(np.array(jparams[name], np.float32)))


def test_moe_train_steps_match_the_jax_ep_step():
    jcfg, tcfg = jmoe.MoEConfig(**CFG), tmoe.MoEConfig(**CFG)
    mesh = jmoe.make_ep_mesh(8, expert_parallel=4)  # ("data", "expert") = (2, 4)
    j_init, j_step = jmoe.make_moe_train_step(jcfg, optax.adam(LR), mesh)
    jp, jo = j_init(seed=0)
    t_init, t_step = tmoe.make_moe_train_step(tcfg, adam(), device="cpu")
    tp, to = t_init(seed=0)
    _into(tp, jax.device_get(jp))
    x, target = _data()
    jl, tl = [], []
    for _ in range(10):
        jp, jo, loss = j_step(jp, jo, x, target)
        jl.append(float(loss))
        tp, to, loss = t_step(tp, to, x, target)
        tl.append(float(loss))
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0], tl


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_moe_loss_and_grads_match_jax(capacity_factor):
    """One loss and its gradient; at factor 0.5 tokens drop at capacity,
    so the gradient also crosses the dropped slots."""
    kw = dict(CFG, capacity_factor=capacity_factor)
    jcfg, tcfg = jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)
    rng = np.random.default_rng(1)
    jparams = {"router": rng.normal(size=(8, 4)) / np.sqrt(8), "wg": rng.normal(size=(4, 8, 16)) / np.sqrt(8),
               "wu": rng.normal(size=(4, 8, 16)) / np.sqrt(8), "wd": rng.normal(size=(4, 16, 8)) / 4.0}
    jparams = {k: v.astype(np.float32) for k, v in jparams.items()}
    x, target = _data(2)

    def loss_fn(params):  # parallel/moe.py:298-301
        y, aux = jmoe.moe_ffn(params, jnp.asarray(x), jcfg)
        return jnp.mean(jnp.square(y - jnp.asarray(target))) + 0.01 * aux

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    tparams = {k: torch.tensor(v, requires_grad=True) for k, v in jparams.items()}
    y, aux = tmoe.moe_ffn(tparams, torch.from_numpy(x), tcfg)
    tloss = (y - torch.from_numpy(target)).square().mean() + 0.01 * aux
    tloss.backward()
    assert rel_l2(float(tloss.detach()), float(jloss)) < 1e-5
    _, jaux = jmoe.moe_ffn(jparams, jnp.asarray(x), jcfg)
    assert rel_l2(float(aux.detach()), float(jaux)) < 1e-5 and float(jaux) > 0
    for name, t in tparams.items():
        assert rel_l2(t.grad.numpy(), np.asarray(jgrads[name])) < 1e-5, name
        assert np.abs(t.grad.numpy()).max() > 0, name


def test_moe_train_step_rejects_an_int8_tree():
    cfg = tmoe.MoEConfig(**CFG)
    t_init, t_step = tmoe.make_moe_train_step(cfg, adam(), device="cpu")
    params, opt = t_init(seed=0)
    q = {"router": params["router"].detach(),
         **{k: tdec._quantize(params[k].detach()) for k in ("wg", "wu", "wd")}}
    x, target = _data()
    with pytest.raises(ValueError, match="serving only"):
        t_step(q, opt, x, target)
    from pathway_tpu_torch.parallel.train import train_state

    with pytest.raises(ValueError, match="serving only"):
        train_state(q, adam())

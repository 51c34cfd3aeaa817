"""The port's LoRA fine-tuning (``models/lora.py::make_lora_train_step``)
against the JAX package's (``tests/test_lora.py:48-76``'s run).

``pw-tiny-decoder`` and ``pw-tiny-moe-decoder`` (f32), rank 4 on ``wq``,
``wv`` and ``wo``, Adam at 1e-2, 8 steps on one batch of 8 × 12 ids.  The
JAX base tree and the JAX step's initial adapters are carried into the
port, which runs on the CPU.  Pins: the losses at 1e-4 relative; the
frozen leaves bitwise equal to the base; every ``b`` moved; the optimizer
holds the adapters and nothing else.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import optax  # noqa: E402

from pathway_tpu.models import decoder as jdec  # noqa: E402
from pathway_tpu.models import lora as jlora  # noqa: E402
from pathway_tpu.parallel import make_mesh  # noqa: E402
from pathway_tpu_torch.models import decoder as tdec  # noqa: E402
from pathway_tpu_torch.models import lora as tlora  # noqa: E402
from pathway_tpu_torch.parallel.train import named_leaves  # noqa: E402

MODELS = ("pw-tiny-decoder", "pw-tiny-moe-decoder")
TARGETS = ("wq", "wv", "wo")
LR = 1e-2
STEPS = 8


def adam(lr=LR):
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _batch(vocab: int):
    rng = np.random.default_rng(1)
    return rng.integers(1, vocab, size=(8, 12)).astype(np.int32), np.full(8, 12, np.int32)


@pytest.fixture(scope="module", params=MODELS)
def run(request):
    """The JAX and the port runs of the same fine-tune: (port config, port
    base, port init_state, port state after the steps, its losses, the JAX
    losses)."""
    jcfg, tcfg = jdec.decoder_config_for(request.param), tdec.decoder_config_for(request.param)
    jbase = jax.device_get(jax.jit(jdec.init_decoder_params, static_argnums=(0, 1))(jcfg, 1))
    ids, lens = _batch(jcfg.vocab_size)
    j_init, j_run = jlora.make_lora_train_step(jcfg, jbase, optax.adam(LR), make_mesh(8), rank=4,
                                               targets=TARGETS)
    jstate = j_init()
    j_adapters = jax.device_get(jstate.params)["layers"]
    jl = []
    for _ in range(STEPS):
        jstate, loss = j_run(jstate, ids, lens)
        jl.append(float(loss))

    tbase = tdec.from_jax_decoder_params(jbase, tcfg, "cpu")
    init_state, t_run = tlora.make_lora_train_step(tcfg, tbase, adam(), device="cpu", rank=4, targets=TARGETS)
    state = init_state()
    with torch.no_grad():  # the JAX step's adapters (the two packages draw differently)
        for name in TARGETS:
            for k in ("a", "b"):
                state.params["layers"][name][k].copy_(torch.from_numpy(np.array(j_adapters[name][k])))
    tl = []
    for _ in range(STEPS):
        state, loss = t_run(state, ids, lens)
        tl.append(float(loss))
    return tcfg, tbase, init_state, state, tl, jl


def test_lora_losses_match_jax(run):
    _, _, _, state, tl, jl = run
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0], tl
    assert state.step == STEPS


def test_lora_moves_only_the_adapters(run):
    _, tbase, _, state, _, _ = run
    base = named_leaves(tbase)
    for name, leaf in named_leaves(state.params).items():
        if name.endswith("/a") or name.endswith("/b"):
            assert leaf.requires_grad, name
            continue
        assert not leaf.requires_grad, name
        key = name[:-2] if name.endswith("/w") else name
        assert torch.equal(leaf, base[key]), name  # bitwise
    for name in TARGETS:
        assert float(state.params["layers"][name]["b"].detach().abs().max()) > 0.0


def test_lora_optimizer_holds_only_the_adapters(run):
    _, _, _, state, _, _ = run
    opt = state.opt_state
    adapters = [t for name, t in named_leaves(state.params).items() if name[-2:] in ("/a", "/b")]
    held = [p for group in opt.param_groups for p in group["params"]]
    assert len(held) == len(adapters) == 2 * len(TARGETS)
    assert {id(p) for p in held} == {id(t) for t in adapters}
    moment_bytes = sum(s[k].numel() * s[k].element_size() for s in opt.state.values()
                       for k in ("exp_avg", "exp_avg_sq"))
    assert moment_bytes == 2 * sum(t.numel() * t.element_size() for t in adapters)


def test_lora_states_have_their_own_adapters(run):
    tcfg, tbase, init_state, _, _, _ = run
    a, b = init_state(), init_state()
    for name in TARGETS:
        torch.testing.assert_close(a.params["layers"][name]["a"], b.params["layers"][name]["a"], rtol=0, atol=0)
        assert a.params["layers"][name]["a"] is not b.params["layers"][name]["a"]
        assert a.params["layers"][name]["w"] is tbase["layers"][name]  # the base is shared, not copied


def test_trained_tree_serves_as_its_merge(run):
    """The fine-tuned adapters serve through ``generate_ids`` as the
    merged tree does (greedy tokens equal)."""
    tcfg, _, _, state, _, _ = run
    lm = tdec.DecoderLM(MODELS[bool(tcfg.experts)], max_cache=64, device="cpu")

    def detached(node):
        return {k: detached(v) for k, v in node.items()} if isinstance(node, dict) else node.detach()

    trained = detached(state.params)
    prompts = [[5, 9, 17], [3, 1, 4, 1, 5, 9, 2, 6]]
    lm.params = trained
    adapted = lm.generate_ids(prompts, max_new_tokens=8)
    lm.params = tlora.merge_lora(trained)
    assert adapted == lm.generate_ids(prompts, max_new_tokens=8)

"""The port's self-speculative decoding against the JAX package's.

Ports the cases of ``tests/test_speculative.py``: ``verify_block`` equals
sequential ``decode_step`` calls (and the JAX ``verify_block``) at the JAX
decoder pin, rtol/atol 2e-4; a perfect draft accepts every token;
``generate_ids_speculative`` emits exactly the plain greedy chain (dense
and MoE), stops at EOS, refuses a quantized target; the done mask freezes
finished rows bit for bit.  Added here: a speculative round matches the JAX
round with the int8 draft, and the draft steps, which write their caches
in place in the port, never touch the target's caches.  JAX weights are
carried across with ``from_jax_decoder_params``; the port runs on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from pathway_tpu.models import decoder as jdec  # noqa: E402
from pathway_tpu_torch.models import decoder as tdec  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
JCFG = jdec.decoder_config_for("pw-tiny-decoder")
TCFG = tdec.decoder_config_for("pw-tiny-decoder")
J_PREFILL = jax.jit(jdec.prefill, static_argnums=(3, 4))
J_VERIFY = jax.jit(jdec.verify_block, static_argnums=(5,))
J_ROUND = jax.jit(jdec.speculative_decode_chunk, static_argnums=(6, 7))


@pytest.fixture(scope="module")
def trees():
    """(JAX float tree, port float tree, JAX int8 tree, port int8 tree)."""
    jtree = jax.device_get(jax.jit(jdec.init_decoder_params, static_argnums=(0, 1))(JCFG, 0))
    jq = jax.device_get(jax.jit(jdec.quantize_decoder_tree)(jtree))
    return jtree, tdec.from_jax_decoder_params(jtree, TCFG, "cpu"), jq, tdec.from_jax_decoder_params(jq, TCFG, "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64))


def _j(a):
    return jnp.asarray(a, jnp.int32)


def _buffer(kc, vc):
    """The draft's own cache: a pair shaped like the target's."""
    return torch.empty_like(kc), torch.empty_like(vc)


def _prefilled(ttree, seed, B, S, C, cfg=TCFG):
    prompt = np.random.default_rng(seed).integers(1, cfg.vocab_size, size=(B, S))
    lens = np.full(B, S)
    logits, kc, vc = tdec.prefill(ttree, _t(prompt), _t(lens), cfg, C)
    return prompt, lens, logits, kc, vc


def _lm(name="pw-tiny-decoder", **kw):
    return tdec.DecoderLM(name, max_cache=64, device="cpu", **{"eos_id": None, **kw})


@pytest.mark.parametrize("window", [None, 3])
def test_verify_block_matches_sequential_decode(trees, window):
    jtree, ttree = trees[:2]
    cfg, jcfg = dataclasses.replace(TCFG, sliding_window=window), dataclasses.replace(JCFG, sliding_window=window)
    B, S, K = 2, 6, 4
    prompt, lens, _, kc, vc = _prefilled(ttree, 0, B, S, 16, cfg)
    block = np.random.default_rng(1).integers(1, cfg.vocab_size, size=(B, K))
    kc_s, vc_s = kc.clone(), vc.clone()
    seq = []
    for i in range(K):
        lg, kc_s, vc_s = tdec.decode_step(ttree, kc_s, vc_s, _t(block[:, i]), _t(lens + i), cfg)
        seq.append(lg)
    _, jk, jv = J_PREFILL(jtree, _j(prompt), _j(lens), jcfg, 16)
    got, kc_b, vc_b = tdec.verify_block(ttree, kc, vc, _t(block), _t(lens), cfg)
    np.testing.assert_allclose(_np(got), _np(torch.stack(seq, dim=1)), **TOL)
    np.testing.assert_allclose(_np(kc_b), _np(kc_s), **TOL)
    np.testing.assert_allclose(_np(vc_b), _np(vc_s), **TOL)
    jl, jk, jv = J_VERIFY(jtree, jk, jv, _j(block), _j(lens), jcfg)
    np.testing.assert_allclose(_np(got), _np(jl), **TOL)
    np.testing.assert_allclose(_np(kc_b), _np(jk), **TOL)


def test_verify_block_past_the_cache_writes_nothing(trees):
    """Block positions at and past the cache length C are no-ops (the JAX
    one-hot scatter writes nothing there); the slots the block wraps onto
    keep their values."""
    jtree, ttree = trees[:2]
    C, S, K = 12, 9, 5  # positions 9..13: two of them past C
    prompt, lens, _, kc, vc = _prefilled(ttree, 2, 2, S, C)
    before = kc.clone()
    block = np.random.default_rng(3).integers(1, TCFG.vocab_size, size=(2, K))
    got, kc, vc = tdec.verify_block(ttree, kc, vc, _t(block), _t(lens), TCFG)
    assert torch.equal(kc[:, :, :S], before[:, :, :S])
    assert float(kc[:, :, S:].abs().amin()) > 0  # the three positions inside were written
    _, jk, jv = J_PREFILL(jtree, _j(prompt), _j(lens), JCFG, C)
    jl, jk, _ = J_VERIFY(jtree, jk, jv, _j(block), _j(lens), JCFG)
    np.testing.assert_allclose(_np(got), _np(jl), **TOL)
    np.testing.assert_allclose(_np(kc), _np(jk), **TOL)


def test_perfect_draft_accepts_everything(trees):
    ttree = trees[1]
    B, S, K = 2, 5, 6
    _, lens, logits, kc, vc = _prefilled(ttree, 1, B, S, 32)
    _, n_match, _, _, _, pos = tdec.speculative_decode_chunk(ttree, ttree, kc, vc, logits, _t(lens), TCFG, K,
                                                           draft_cache=_buffer(kc, vc))
    assert n_match.tolist() == [K, K]
    assert pos.tolist() == [S + K, S + K]


def test_round_matches_jax_with_the_int8_draft(trees):
    """One round with the int8 draft: the JAX round's tokens and acceptance
    exactly, its next logits and caches at the pin."""
    jtree, ttree, jq, tq = trees
    B, S, K, C = 3, 7, 5, 32
    prompt, lens, logits, kc, vc = _prefilled(ttree, 4, B, S, C)
    jl, jk, jv = J_PREFILL(jtree, _j(prompt), _j(lens), JCFG, C)
    done = np.array([False, True, False])
    got = tdec.speculative_decode_chunk(ttree, tq, kc, vc, logits, _t(lens), TCFG, K, done=torch.from_numpy(done),
                                        draft_cache=_buffer(kc, vc))
    want = J_ROUND(jtree, jq, jk, jv, jl, _j(lens), JCFG, K, jnp.asarray(done))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    for g, w in zip(got[2:5], want[2:5]):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_draft_steps_leave_the_target_cache_alone(trees):
    """The draft's decode steps write into their own buffer (refreshed from
    the target's caches), never into the target's: after a round the target
    caches are what the verify sweep alone leaves, bit for bit, and the
    draft buffer holds the draft's own writes."""
    ttree, tq = trees[1], trees[3]
    B, S, K, C = 2, 6, 5, 32
    _, lens, logits, kc, vc = _prefilled(ttree, 5, B, S, C)
    kc0, vc0 = kc.clone(), vc.clone()
    draft = (torch.full_like(kc, 7.0), torch.full_like(vc, 7.0))
    toks, n_match, _, kc, vc, _ = tdec.speculative_decode_chunk(
        ttree, tq, kc, vc, logits, _t(lens), TCFG, K, draft_cache=draft)
    _, want_k, want_v = tdec.verify_block(ttree, kc0.clone(), vc0.clone(), toks, _t(lens), TCFG)
    for want in (want_k, want_v):
        for b in range(B):
            want[:, b, S + int(n_match[b]) : S + K] = 0
    assert torch.equal(kc, want_k) and torch.equal(vc, want_v)
    # the draft buffer: the target's history, then the int8 draft's K/V
    assert torch.equal(draft[0][:, :, :S], kc0[:, :, :S])
    assert not torch.equal(draft[0][:, :, S : S + K - 1], want_k[:, :, S : S + K - 1])
    assert float(draft[0][:, :, S + K - 1 :].abs().max()) == 0.0


def test_done_mask_freezes_finished_rows(trees):
    ttree = trees[1]
    B, S, K = 2, 5, 4
    _, lens, logits, kc, vc = _prefilled(ttree, 2, B, S, 32)
    kc0, vc0 = kc.clone(), vc.clone()
    _, n_match, _, kc2, vc2, pos = tdec.speculative_decode_chunk(
        ttree, ttree, kc, vc, logits, _t(lens), TCFG, K, done=torch.tensor([True, False]),
        draft_cache=_buffer(kc, vc))
    assert int(n_match[0]) == 0 and int(pos[0]) == S
    assert int(n_match[1]) == K and int(pos[1]) == S + K
    assert torch.equal(kc2[:, 0], kc0[:, 0]) and torch.equal(vc2[:, 0], vc0[:, 0])


def test_speculative_matches_plain_greedy():
    lm = _lm()
    prompts = [[5, 9, 3], [7], [11, 2, 4, 8]]
    want = lm.generate_ids(prompts, max_new_tokens=12)
    got = lm.generate_ids_speculative(prompts, max_new_tokens=12, n_draft=4)
    assert got == want
    stats = lm.speculative_stats
    assert stats["rounds"] >= 3 and stats["row_rounds"] >= 9
    assert stats["row_rounds"] <= stats["accepted"] <= 4 * stats["row_rounds"]
    assert isinstance(lm._draft_tree["layers"]["wq"], dict)  # the int8 draft


def test_speculative_respects_eos():
    base = _lm().generate_ids([[5, 9, 3]], max_new_tokens=10)[0]
    eos = base[4]
    lm = _lm(eos_id=eos)
    want = lm.generate_ids([[5, 9, 3]], max_new_tokens=10)
    got = lm.generate_ids_speculative([[5, 9, 3]], max_new_tokens=10, n_draft=4)
    assert got == want
    assert eos not in got[0]


def test_speculative_matches_greedy_on_moe_decoder():
    lm = _lm("pw-tiny-moe-decoder")
    prompts = [[5, 9, 3], [7, 11]]
    assert lm.generate_ids_speculative(prompts, max_new_tokens=8, n_draft=4) == \
        lm.generate_ids(prompts, max_new_tokens=8)


def test_speculative_rejects_quantized_target_and_bad_arguments():
    with pytest.raises(ValueError, match="float tree"):
        _lm(quantize="int8").generate_ids_speculative([[1, 2]], max_new_tokens=4)
    lm = _lm()
    with pytest.raises(ValueError, match="max_new_tokens"):
        lm.generate_ids_speculative([[1, 2]], max_new_tokens=64)
    with pytest.raises(ValueError, match="n_draft"):
        lm.generate_ids_speculative([[1, 2]], max_new_tokens=4, n_draft=0)

"""The port's Mixtral-style MoE decoder (``cfg.experts > 0``) against the
JAX package's.

Mirrors ``tests/test_moe_decoder.py`` on ``pw-tiny-moe-decoder`` (f32, 4
experts, top-2): identical experts give the dense decoder; prefill, decode
and the paged steps (every serving path dispatches with ``full_capacity``)
match the JAX package's logits and caches at its decoder pin (rtol/atol
2e-4); greedy tokens exactly.  The JAX init is carried across with
``from_jax_decoder_params``; inputs come from numpy with a seed; the port
runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from pathway_tpu.models import decoder as jdec  # noqa: E402
from pathway_tpu_torch.models import decoder as tdec  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
JCFG = jdec.decoder_config_for("pw-tiny-moe-decoder")
TCFG = tdec.decoder_config_for("pw-tiny-moe-decoder")
J_PREFILL = jax.jit(jdec.prefill, static_argnums=(3, 4))
J_DECODE = jax.jit(jdec.decode_step, static_argnums=(5,))
J_CHUNK = jax.jit(jdec.paged_prefill_chunk, static_argnums=(7,))
J_STEP = jax.jit(jdec.paged_decode_step, static_argnums=(6,))


@pytest.fixture(scope="module")
def trees():
    jtree = jax.device_get(jax.jit(jdec.init_decoder_params, static_argnums=(0, 1))(JCFG, 2))
    return jtree, tdec.from_jax_decoder_params(jtree, TCFG, "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64))


def _j(a):
    return jnp.asarray(a, jnp.int32)


def test_identical_experts_match_dense_decoder():
    """Every expert a copy of the dense MLP: the MoE decoder's logits are the
    dense decoder's (renormalised gates sum to 1)."""
    dense_cfg = dataclasses.replace(TCFG, experts=0)
    dense = tdec.init_decoder_params(dense_cfg, seed=0, device="cpu")
    moe = tdec.init_decoder_params(TCFG, seed=0, device="cpu")
    for name in ("embed", "final_norm", "lm_head"):
        moe[name] = dense[name]
    for name in ("ln0", "ln1", "wq", "wk", "wv", "wo"):
        moe["layers"][name] = dense["layers"][name]
    for name in ("wg", "wu", "wd"):
        moe["layers"][name] = dense["layers"][name][:, None].expand_as(moe["layers"][name]).contiguous()
    rng = np.random.default_rng(0)
    ids, lens = _t(rng.integers(1, TCFG.vocab_size, size=(4, 10))), _t([10, 7, 5, 9])
    want = tdec.prefill(dense, ids, lens, dense_cfg, 16)
    got = tdec.prefill(moe, ids, lens, TCFG, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-4)


def test_prefill_matches_jax(trees):
    jtree, ttree = trees
    rng = np.random.default_rng(1)
    ids = rng.integers(1, JCFG.vocab_size, size=(3, 16))
    lens = np.array([16, 9, 1])
    jl, jk, jv = J_PREFILL(jtree, _j(ids), _j(lens), JCFG, 32)
    tl, tk, tv = tdec.prefill(ttree, _t(ids), _t(lens), TCFG, 32)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)


def test_decode_steps_match_jax_and_prefill(trees):
    """Decode steps from a prefilled prefix match the JAX steps, and the
    step at position S gives what prefill over S + 1 tokens gives."""
    jtree, ttree = trees
    rng = np.random.default_rng(3)
    B, S, C, cut = 2, 12, 32, 4
    ids = rng.integers(1, JCFG.vocab_size, size=(B, S))
    cutv = np.full(B, cut)
    jl, jk, jv = J_PREFILL(jtree, _j(ids), _j(cutv), JCFG, C)
    tl, tk, tv = tdec.prefill(ttree, _t(ids), _t(cutv), TCFG, C)
    for t in range(cut, S):
        pos = np.full(B, t)
        jl, jk, jv = J_DECODE(jtree, jk, jv, _j(ids[:, t]), _j(pos), JCFG)
        tl, tk, tv = tdec.decode_step(ttree, tk, tv, _t(ids[:, t]), _t(pos), TCFG)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)
    whole = tdec.prefill(ttree, _t(ids), _t([S, S]), TCFG, C)[0]
    np.testing.assert_allclose(_np(tl), _np(whole), **TOL)


def test_paged_steps_match_jax(trees):
    """Chunked paged prefill over a ragged batch, then paged decode steps
    fed the greedy tokens: logits and pools at every call."""
    jtree, ttree = trees
    lens, chunk, page, G = [9, 3], 4, 4, 4
    S = len(lens)
    rng = np.random.default_rng(4)
    ids = np.zeros((S, max(lens)), np.int64)
    for s, n in enumerate(lens):
        ids[s, :n] = rng.integers(1, JCFG.vocab_size, n)
    bt = (1 + np.arange(S * G)).reshape(S, G)
    tk, tv = tdec.init_kv_pool(TCFG, 1 + S * G, page, "cpu")
    jk, jv = jdec.init_kv_pool(JCFG, 1 + S * G, page)
    logits = None
    for start in range(0, max(lens), chunk):
        cids = np.zeros((S, chunk), np.int64)
        clens = np.array([max(0, min(chunk, n - start)) for n in lens])
        for s in range(S):
            cids[s, : clens[s]] = ids[s, start : start + clens[s]]
        starts = np.full(S, start)
        tl, tk, tv = tdec.paged_prefill_chunk(ttree, tk, tv, _t(bt), _t(cids), _t(clens), _t(starts), TCFG)
        jl, jk, jv = J_CHUNK(jtree, jk, jv, _j(bt), _j(cids), _j(clens), _j(starts), JCFG)
        live = clens > 0
        np.testing.assert_allclose(_np(tl)[live], _np(jl)[live], **TOL)
        take = torch.from_numpy((start < np.array(lens)) & (start + chunk >= np.array(lens)))
        logits = tl if logits is None else torch.where(take[:, None], tl, logits)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    pos = np.array(lens)
    for _ in range(4):
        tok = logits.argmax(-1).numpy()
        logits, tk, tv = tdec.paged_decode_step(ttree, tk, tv, _t(bt), _t(pos), _t(tok), TCFG)
        jl, jk, jv = J_STEP(jtree, jk, jv, _j(bt), _j(pos), _j(tok), JCFG)
        np.testing.assert_allclose(_np(logits), _np(jl), **TOL)
        pos += 1
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)


def test_long_prefill_runs_serving_groups_one_at_a_time(trees, monkeypatch):
    """A prefill of more tokens than the serving group size (1,024 tokens
    here, in two groups) calls the expert FFN once per group, and gives the
    JAX package's logits."""
    from pathway_tpu_torch.parallel import moe as tmoe

    jtree, ttree = trees
    calls = []
    orig = tmoe._groups_ffn

    def counted(params, router_logits, *args):
        calls.append(router_logits.shape[:2])
        return orig(params, router_logits, *args)

    monkeypatch.setattr(tmoe, "_groups_ffn", counted)
    rng = np.random.default_rng(6)
    ids = rng.integers(1, JCFG.vocab_size, size=(9, 128))
    lens = np.full(9, 128)
    tl, _, _ = tdec.prefill(ttree, _t(ids), _t(lens), TCFG, 128)
    assert calls == [(1, 1024), (1, 1024)] * TCFG.layers
    jl, _, _ = J_PREFILL(jtree, _j(ids), _j(lens), JCFG, 128)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_greedy_generate_ids_matches_jax(trees, monkeypatch):
    """``DecoderLM`` on the MoE preset with the JAX LM's weights: the same
    greedy tokens, deterministic, and the same param count."""
    monkeypatch.setitem(sys.modules, "transformers", None)  # no checkpoint lookup
    jlm = jdec.DecoderLM("pw-tiny-moe-decoder", max_cache=64, eos_id=None)
    tlm = tdec.DecoderLM("pw-tiny-moe-decoder", max_cache=64, eos_id=None, device="cpu")
    assert tlm.config.experts == 4 and tlm.n_params() == jlm.n_params()
    assert not tlm.quantized and tlm.params["layers"]["wg"].dtype == torch.float32  # never quantized unasked
    tlm.params = tdec.from_jax_decoder_params(jax.device_get(jlm.params), tlm.config, "cpu")
    prompts = [[5, 9, 3], [7], [11, 2, 4, 8, 30, 31]]
    got = tlm.generate_ids(prompts, max_new_tokens=8)
    assert got == jlm.generate_ids(prompts, max_new_tokens=8)
    assert got == tlm.generate_ids(prompts, max_new_tokens=8)

"""The port's dense decoder against the JAX package's.

``pw-tiny-decoder`` (f32, 4 heads over 2 KV heads) and a tiny config with
an 8-token sliding window.  The JAX tree from ``init_decoder_params`` is
carried into the port with ``from_jax_decoder_params``; inputs come from
numpy with a seed; the port runs on the CPU.  Logits and caches are held
at the JAX package's own pin (rtol/atol 2e-4, ``tests/test_decoder.py``),
greedy tokens exactly.
"""

from __future__ import annotations

import dataclasses
import json

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
JCFG_SW = dataclasses.replace(JCFG, sliding_window=8)
TCFG_SW = dataclasses.replace(TCFG, sliding_window=8)
CONFIGS = {"full": (JCFG, TCFG), "window8": (JCFG_SW, TCFG_SW)}
# the JAX references, compiled once per shape
J_PREFILL = jax.jit(jdec.prefill, static_argnums=(3, 4))
J_DECODE = jax.jit(jdec.decode_step, static_argnums=(5,))


@pytest.fixture(scope="module")
def lms():
    """The JAX package's DecoderLM and the port's, with the JAX weights."""
    jlm = jdec.DecoderLM("pw-tiny-decoder", max_cache=64, eos_id=None)
    tlm = tdec.DecoderLM("pw-tiny-decoder", max_cache=64, eos_id=None, device="cpu")
    tlm.params = tdec.from_jax_decoder_params(jax.device_get(jlm.params), tlm.config, "cpu")
    return jlm, tlm


@pytest.fixture(scope="module")
def trees(lms):
    jlm, tlm = lms
    return jlm.params, tlm.params


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ids(rng, B, S):
    return rng.integers(1, JCFG.vocab_size, size=(B, S))


# ---------------------------------------------------------------------------
# Config and weights
# ---------------------------------------------------------------------------


def test_presets_match_the_jax_package():
    assert set(tdec.PRESETS) == set(jdec.PRESETS)
    for name, jc in jdec.PRESETS.items():
        tc = tdec.PRESETS[name]
        for field in dataclasses.fields(tc):
            if field.name == "dtype":
                assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name, name
            else:
                assert getattr(tc, field.name) == getattr(jc, field.name), (name, field.name)
        assert tc.head_dim == jc.head_dim


def test_config_from_local_checkpoint_dir(tmp_path):
    hf = {"vocab_size": 1000, "hidden_size": 96, "num_hidden_layers": 3,
          "num_attention_heads": 6, "num_key_value_heads": 2,
          "intermediate_size": 200, "max_position_embeddings": 16384,
          "rope_theta": 5e5, "rms_norm_eps": 1e-6, "sliding_window": 64}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    tc = tdec.decoder_config_for(str(tmp_path))
    jc = jdec.decoder_config_for(str(tmp_path))
    for field in dataclasses.fields(tc):
        if field.name != "dtype":
            assert getattr(tc, field.name) == getattr(jc, field.name), field.name
    assert tc.max_len == 8192 and tc.head_dim == 16
    with pytest.raises(ValueError, match="unknown decoder model"):
        tdec.decoder_config_for(str(tmp_path / "missing"))


@pytest.mark.parametrize("n,cap", [(1, 64), (16, 64), (17, 64), (100, 64), (40, 1024), (900, 1024)])
def test_bucket_prompt_len(n, cap):
    assert tdec._bucket_prompt_len(n, cap) == jdec._bucket_prompt_len(n, cap)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("name", ["pw-tiny-decoder", "pw-tiny-moe-decoder"])
def test_init_tree_shapes_and_scales(name):
    """Same tree and shapes as the JAX init; normal / sqrt(fan_in) scales,
    ones for the norms; deterministic per seed."""
    jc, tc = jdec.decoder_config_for(name), tdec.decoder_config_for(name)
    jl = _leaves(jax.eval_shape(lambda: jdec.init_decoder_params(jc, seed=0)))
    tl = _leaves(tdec.init_decoder_params(tc, seed=0, device="cpu"))
    assert set(tl) == set(jl)
    for path, w in tl.items():
        assert tuple(w.shape) == jl[path].shape, path
        if path.endswith(("ln0", "ln1", "final_norm")):
            assert bool((w == 1).all()), path
        else:
            fan_in = w.shape[-1] if path == "embed" else w.shape[-2]
            std = float(w.float().std())
            assert abs(std * np.sqrt(fan_in) - 1.0) < 0.1, (path, std)
    assert tl["layers/wq"].dtype == tc.dtype
    again = tdec.init_decoder_params(tc, seed=0, device="cpu")
    assert torch.equal(again["lm_head"], tl["lm_head"])
    other = tdec.init_decoder_params(tc, seed=1, device="cpu")
    assert not torch.equal(other["lm_head"], tl["lm_head"])


def test_from_jax_params_carries_bf16_tree(trees):
    jtree = jax.tree.map(lambda a: np.asarray(a).astype(jnp.bfloat16), trees[0])
    ttree = tdec.from_jax_decoder_params(jtree, dataclasses.replace(TCFG, dtype=torch.bfloat16), "cpu")
    assert ttree["layers"]["wg"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(ttree["layers"]["wg"]), np.asarray(jtree["layers"]["wg"], np.float32))


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def test_rms_rope_and_window_mask():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tdec._rms(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)),
        _np(jdec._rms(jnp.asarray(x), jnp.asarray(scale), 1e-5)), **TOL)
    pos = rng.integers(0, 900, size=(2, 5))
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            _np(tdec._rope(torch.from_numpy(x), torch.from_numpy(pos), theta)),
            _np(jdec._rope(jnp.asarray(x), jnp.asarray(pos), theta)), **TOL)
    q, k = np.arange(20)[:, None], np.arange(20)[None, :]
    np.testing.assert_array_equal(
        tdec._sw_mask(torch.from_numpy(q), torch.from_numpy(k), 8).numpy(),
        np.asarray(jdec._sw_mask(q, k, 8)))


def test_attend_matches_jax():
    rng = np.random.default_rng(1)
    B, S, C = 2, 3, 9
    q = rng.normal(size=(B, S, 4, 16)).astype(np.float32)
    k = rng.normal(size=(B, C, 2, 16)).astype(np.float32)
    v = rng.normal(size=(B, C, 2, 16)).astype(np.float32)
    mask = rng.random((B, S, C)) < 0.7
    mask[:, :, 0] = True
    got = tdec._attend(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    want = jdec._attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), JCFG)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ---------------------------------------------------------------------------
# prefill / decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_prefill_logits_and_caches_match_jax(trees, config):
    jc, tc = CONFIGS[config]
    jtree, ttree = trees
    rng = np.random.default_rng(2)
    ids = _ids(rng, 3, 16)
    lens = np.array([16, 9, 1])
    jl, jk, jv = J_PREFILL(jtree, jnp.asarray(ids, jnp.int32), jnp.asarray(lens, jnp.int32), jc, 32)
    tl, tk, tv = tdec.prefill(ttree, torch.from_numpy(ids), torch.from_numpy(lens), tc, 32)
    assert tuple(tk.shape) == jk.shape
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)
    # K/V past each row's length are zero: decode steps write into them
    assert float(tk[:, 1, 9:].abs().sum()) == 0.0


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_decode_steps_match_jax(trees, config):
    """Decode from a prefilled prefix, feeding real tokens: logits and
    caches stay within the pin of the JAX decode at every step."""
    jc, tc = CONFIGS[config]
    jtree, ttree = trees
    rng = np.random.default_rng(3)
    B, S, C, cut = 2, 14, 32, 4
    ids = _ids(rng, B, S)
    cutv = np.full(B, cut)
    jl, jk, jv = J_PREFILL(jtree, jnp.asarray(ids, jnp.int32), jnp.asarray(cutv, jnp.int32), jc, C)
    tl, tk, tv = tdec.prefill(ttree, torch.from_numpy(ids), torch.from_numpy(cutv), tc, C)
    for t in range(cut, S):
        pos = np.full(B, t)
        jl, jk, jv = J_DECODE(jtree, jk, jv, jnp.asarray(ids[:, t], jnp.int32),
                                      jnp.asarray(pos, jnp.int32), jc)
        tl, tk, tv = tdec.decode_step(ttree, tk, tv, torch.from_numpy(ids[:, t]),
                                      torch.from_numpy(pos), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)


def test_decode_step_past_the_cache_writes_nothing(trees):
    _, ttree = trees
    C = 8
    kc = torch.zeros((TCFG.layers, 1, C, TCFG.kv_heads, TCFG.head_dim))
    vc = torch.zeros_like(kc)
    tdec.decode_step(ttree, kc, vc, torch.tensor([5]), torch.tensor([C]), TCFG)
    assert float(kc.abs().sum()) == 0.0 and float(vc.abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

# 16-token logits; every cut edge of the filters below is at least 0.007
# from the probability or prefix mass it is compared with
LOGITS = np.log(np.array(
    [[25, 18, 13, 10, 8, 6.5, 5, 4, 3, 2.2, 1.6, 1.2, 1.0, 1.0, 1.0, 1.0],
     [2, 3, 60, 1.1, 24, 1.2, 1.3, 2.5, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]],
    np.float64)).astype(np.float32)
ALL = set(range(16))
FILTERS = [
    ({"top_k": 3}, [{0, 1, 2}, {2, 4, 1}]),
    ({"top_k": 1000}, [ALL, ALL]),
    ({"top_p": 0.5}, [{0, 1, 2}, {2}]),
    ({"top_p": 0.75}, [{0, 1, 2, 3, 4, 5}, {2, 4}]),
    ({"top_p": 0.0}, [{0}, {2}]),
    ({"min_p": 0.3}, [{0, 1, 2, 3, 4}, {2, 4}]),
    ({"min_p": 0.1}, [set(range(9)), {2, 4}]),
    ({"min_p": 0.0}, [ALL, ALL]),
    ({"min_p": 2.0}, [{0}, {2}]),
    ({"top_k": 5, "top_p": 0.6, "min_p": 0.1}, [{0, 1, 2}, {2}]),
]


@pytest.mark.parametrize("kwargs,support", FILTERS, ids=[str(f[0]) for f in FILTERS])
def test_sampling_support_matches_jax(kwargs, support):
    """The support the filters leave is the listed one; every token the
    port and the JAX package draw lies in it, and the port's 4,096 draws
    per row cover it."""
    draws = 4096
    lg = np.repeat(LOGITS, draws, axis=0)
    kept = tdec._filter_logits(torch.from_numpy(LOGITS), **kwargs)
    assert [set(np.flatnonzero(np.isfinite(r.numpy()))) for r in kept] == support
    gen = torch.Generator().manual_seed(0)
    got = tdec.sample_logits(torch.from_numpy(lg), gen, 1.0, **kwargs).numpy().reshape(2, draws)
    want = np.asarray(jdec.sample_logits(jnp.asarray(lg), jax.random.PRNGKey(0), 1.0, **kwargs)).reshape(2, draws)
    for row in range(2):
        assert set(got[row]) == support[row]
        assert set(want[row]) <= support[row]


def test_sampling_takes_per_row_tensors():
    """The scheduler's form: per-row temperature, top_p and min_p as
    ``[B, 1]`` tensors."""
    gen = torch.Generator().manual_seed(1)
    lg = torch.from_numpy(np.repeat(LOGITS, 512, axis=0))
    top_p = torch.tensor([[0.5]] * 512 + [[0.75]] * 512)
    min_p = torch.zeros((1024, 1))
    temp = torch.ones((1024, 1))
    tok = tdec.sample_logits(lg, gen, temp, top_p=top_p, min_p=min_p).numpy()
    assert set(tok[:512]) == {0, 1, 2} and set(tok[512:]) == {2, 4}


def test_repetition_penalty_matches_jax():
    rng = np.random.default_rng(4)
    lg = rng.normal(size=(3, 40)).astype(np.float32) * 3
    seen = rng.random((3, 40)) < 0.4
    for penalty in (1.0, 1.3, 0.7):
        got = tdec.apply_repetition_penalty(torch.from_numpy(lg), torch.from_numpy(seen), penalty)
        want = jdec.apply_repetition_penalty(jnp.asarray(lg), jnp.asarray(seen), penalty)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# DecoderLM
# ---------------------------------------------------------------------------


def test_greedy_generate_ids_matches_jax(lms):
    jlm, tlm = lms
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, 500, n)] for n in (3, 11, 1, 7)]
    assert tlm.generate_ids(prompts, max_new_tokens=16) == jlm.generate_ids(prompts, max_new_tokens=16)


def test_greedy_with_repetition_penalty_matches_jax(lms):
    jlm, tlm = lms
    prompts = [[5, 9, 17, 5], [3, 3, 3]]
    got = tlm.generate_ids(prompts, max_new_tokens=16, repetition_penalty=1.5)
    assert got == jlm.generate_ids(prompts, max_new_tokens=16, repetition_penalty=1.5)
    assert got != tlm.generate_ids(prompts, max_new_tokens=16)


def test_generate_keeps_prompt_tail_and_validates(lms):
    jlm, tlm = lms
    long = list(range(1, 80))  # longer than max_cache - max_new_tokens
    assert tlm.generate_ids([long], max_new_tokens=16) == jlm.generate_ids([long], max_new_tokens=16)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tlm.generate_ids([[1]], max_new_tokens=64)
    with pytest.raises(ValueError, match="repetition_penalty"):
        tlm.generate_ids([[1]], max_new_tokens=4, repetition_penalty=0.0)


def test_sampled_generation_stays_in_support(lms):
    """Sampled rows: deterministic per seed, and with top_k=1 every draw is
    the greedy token."""
    _, tlm = lms
    prompts = [[5, 9, 17], [2, 4]]
    a = tlm.generate_ids(prompts, max_new_tokens=10, temperature=0.8, seed=3, top_p=0.9)
    assert a == tlm.generate_ids(prompts, max_new_tokens=10, temperature=0.8, seed=3, top_p=0.9)
    assert all(len(r) == 10 for r in a)
    assert tlm.generate_ids(prompts, max_new_tokens=10, temperature=0.8, top_k=1) == \
        tlm.generate_ids(prompts, max_new_tokens=10)
    assert tlm.generate_ids(prompts, max_new_tokens=10, temperature=0.8, min_p=1.0) == \
        tlm.generate_ids(prompts, max_new_tokens=10)


def test_eos_stops_rows(lms):
    jlm, tlm = lms
    prompt = [[7, 8, 9]]
    ref = tlm.generate_ids(prompt, max_new_tokens=8)
    eos = ref[0][3]
    stop = tdec.DecoderLM("pw-tiny-decoder", max_cache=64, eos_id=eos, device="cpu")
    stop.params = tlm.params
    got = stop.generate_ids(prompt, max_new_tokens=8)[0]
    assert got == ref[0][: ref[0].index(eos)]


def test_text_generation_and_param_count(lms):
    jlm, tlm = lms
    assert tlm.n_params() == jlm.n_params()
    text = tlm.generate("streaming answer please", max_new_tokens=16)
    assert text == jlm.generate("streaming answer please", max_new_tokens=16)
    many = tlm.generate_many(["a b c", "longer prompt here"], max_new_tokens=16)
    assert many == jlm.generate_many(["a b c", "longer prompt here"], max_new_tokens=16)

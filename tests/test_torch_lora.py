"""The port's LoRA adapters (``models/lora.py``) and the decoder's LoRA
branch of ``_mm``, against the JAX package's.

``pw-tiny-decoder`` and ``pw-tiny-moe-decoder`` (f32).  The JAX base tree
is carried into the port, and so is a JAX adapted tree whose ``b`` is drawn
at std 0.02 (as ``tests/test_lora.py:81-84`` does) so that the adapters
change the output.  Pins: logits at the JAX package's decoder pin (rtol/atol
2e-4), greedy tokens exactly, merged against adapted at 2e-5
(``tests/test_lora.py:91``), zero-init adapters bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from pathway_tpu.models import decoder as jdec  # noqa: E402
from pathway_tpu.models import lora as jlora  # noqa: E402
from pathway_tpu_torch.models import decoder as tdec  # noqa: E402
from pathway_tpu_torch.models import lora as tlora  # noqa: E402
from pathway_tpu_torch.serving import generation  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
MERGE_TOL = dict(rtol=2e-5, atol=2e-5)
MODELS = ("pw-tiny-decoder", "pw-tiny-moe-decoder")
J_INIT = jax.jit(jdec.init_decoder_params, static_argnums=(0, 1))
J_PREFILL = jax.jit(jdec.prefill, static_argnums=(3, 4))
J_DECODE = jax.jit(jdec.decode_step, static_argnums=(5,))


def _configs(name):
    return jdec.decoder_config_for(name), tdec.decoder_config_for(name)


def _jax_adapted(jtree, jcfg, seed=1, targets=jlora.DEFAULT_TARGETS):
    """A JAX adapted tree with nonzero ``b`` (std 0.02) on every target."""
    tree = jlora.lora_decoder_tree(jtree, jcfg, rank=4, seed=seed, targets=targets)
    layers = dict(tree["layers"])
    for i, name in enumerate(targets):
        leaf = dict(layers[name])
        key = jax.random.PRNGKey(100 + seed + i)
        leaf["b"] = (jax.random.normal(key, leaf["b"].shape) * 0.02).astype(leaf["b"].dtype)
        layers[name] = leaf
    return jax.device_get({**tree, "layers": layers})


@pytest.fixture(scope="module", params=MODELS)
def trees(request):
    """(name, JAX base, port base, JAX adapted, port adapted)."""
    jcfg, tcfg = _configs(request.param)
    jbase = jax.device_get(J_INIT(jcfg, 3))
    jad = _jax_adapted(jbase, jcfg)
    return (request.param, jbase, tdec.from_jax_decoder_params(jbase, tcfg, "cpu"), jad,
            tdec.from_jax_decoder_params(jad, tcfg, "cpu"))


@pytest.fixture(scope="module")
def dense_trees():
    """The dense tiny decoder's JAX and port trees, base and adapted."""
    jcfg, tcfg = _configs(MODELS[0])
    jbase = jax.device_get(J_INIT(jcfg, 5))
    jad = _jax_adapted(jbase, jcfg, seed=2)
    return (jbase, tdec.from_jax_decoder_params(jbase, tcfg, "cpu"), jad,
            tdec.from_jax_decoder_params(jad, tcfg, "cpu"))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64))


def _j(a):
    return jnp.asarray(a, jnp.int32)


def _ids(seed, B=2, S=9):
    return np.random.default_rng(seed).integers(1, 512, size=(B, S))


# ---------------------------------------------------------------------------
# The adapter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_tree_matches_jax(name):
    """Same leaves, shapes and dtypes as the JAX package's adapted tree; the
    base weights are the tree's own tensors; ``b`` zeros; ``a`` drawn at
    (alpha/rank)/sqrt(H)."""
    jcfg, tcfg = _configs(name)
    jbase = jax.device_get(J_INIT(jcfg, 0))
    tbase = tdec.from_jax_decoder_params(jbase, tcfg, "cpu")
    targets = ("wq", "wk", "wv", "wo")
    jad = jlora.lora_decoder_tree(jbase, jcfg, rank=4, alpha=8.0, targets=targets)
    tad = tlora.lora_decoder_tree(tbase, tcfg, rank=4, alpha=8.0, targets=targets)
    assert set(tad) == set(jad) and set(tad["layers"]) == set(jad["layers"])
    for leaf_name, jleaf in jad["layers"].items():
        tleaf = tad["layers"][leaf_name]
        if leaf_name not in targets:
            assert tleaf is tbase["layers"][leaf_name]
            continue
        assert set(tleaf) == set(jleaf) == {"w", "a", "b"}
        assert tleaf["w"] is tbase["layers"][leaf_name]
        for k in ("a", "b"):
            assert tuple(tleaf[k].shape) == tuple(jleaf[k].shape), (leaf_name, k)
            assert str(tleaf[k].dtype).split(".")[-1] == jnp.dtype(jleaf[k].dtype).name
        assert not bool(tleaf["b"].any())
        H = tleaf["w"].shape[-2]
        assert float(tleaf["a"].std()) == pytest.approx((8.0 / 4) / np.sqrt(H), rel=0.15)
    again = tlora.lora_decoder_tree(tbase, tcfg, rank=4, alpha=8.0, targets=targets)
    assert torch.equal(again["layers"]["wq"]["a"], tad["layers"]["wq"]["a"])
    assert tbase["layers"]["wq"] is not tad["layers"]["wq"]  # the base tree is left as it was


@pytest.mark.parametrize("case", ["unknown", "wrapped", "moe-mlp"])
def test_errors_match_jax(case):
    name = "pw-tiny-moe-decoder" if case == "moe-mlp" else "pw-tiny-decoder"
    jcfg, tcfg = _configs(name)
    jbase = jax.device_get(J_INIT(jcfg, 0))
    tbase = tdec.from_jax_decoder_params(jbase, tcfg, "cpu")
    targets = {"unknown": ("wq", "wz"), "wrapped": ("wq",), "moe-mlp": ("wq", "wd")}[case]
    if case == "wrapped":
        jbase = jlora.lora_decoder_tree(jbase, jcfg)
        tbase = tlora.lora_decoder_tree(tbase, tcfg)
    with pytest.raises(ValueError) as ref:
        jlora.lora_decoder_tree(jbase, jcfg, targets=targets)
    with pytest.raises(ValueError) as got:
        tlora.lora_decoder_tree(tbase, tcfg, targets=targets)
    assert str(got.value) == str(ref.value)
    if case == "moe-mlp":
        assert "MoE" in str(got.value)
        # attention-only targets work on MoE configs
        assert isinstance(tlora.lora_decoder_tree(tbase, tcfg)["layers"]["wq"], dict)


def test_zero_init_equals_base_bit_for_bit(trees):
    name, _, tbase, _, _ = trees
    tcfg = tdec.decoder_config_for(name)
    tad = tlora.lora_decoder_tree(tbase, tcfg, rank=4, seed=9)
    ids, lens = _t(_ids(0)), _t([9, 5])
    base = tdec.prefill(tbase, ids, lens, tcfg, 16)
    ad = tdec.prefill(tad, ids, lens, tcfg, 16)
    for b, a in zip(base, ad):
        assert torch.equal(a, b)
    tok = base[0].argmax(-1)
    assert torch.equal(tdec.decode_step(tad, ad[1], ad[2], tok, lens, tcfg)[0],
                       tdec.decode_step(tbase, base[1], base[2], tok, lens, tcfg)[0])


def test_jax_lora_leaves_carry_across(trees):
    _, _, _, jad, tad = trees
    for name in jlora.DEFAULT_TARGETS:
        assert set(tad["layers"][name]) == {"w", "a", "b"}
        for k in ("w", "a", "b"):
            np.testing.assert_array_equal(_np(tad["layers"][name][k]), np.asarray(jad["layers"][name][k], np.float32))


# ---------------------------------------------------------------------------
# The adapted decoder against the JAX package's
# ---------------------------------------------------------------------------


def test_adapted_dense_logits_match_jax(trees):
    """Prefill and four decode steps over the adapted tree (dense and MoE
    attention alike): logits at 2e-4, and apart from the base's."""
    name, _, tbase, jad, tad = trees
    jcfg, tcfg = _configs(name)
    ids, lens = _ids(1), np.array([9, 6])
    jl, jk, jv = J_PREFILL(jad, _j(ids), _j(lens), jcfg, 16)
    tl, tk, tv = tdec.prefill(tad, _t(ids), _t(lens), tcfg, 16)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert np.abs(_np(tl) - _np(tdec.prefill(tbase, _t(ids), _t(lens), tcfg, 16)[0])).max() > 1e-3
    pos = lens.copy()
    for _ in range(4):
        tok = _np(tl).argmax(-1)
        jl, jk, jv = J_DECODE(jad, jk, jv, _j(tok), _j(pos), jcfg)
        tl, tk, tv = tdec.decode_step(tad, tk, tv, _t(tok), _t(pos), tcfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        pos += 1
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)


def _jax_greedy(jtree, prompts, steps):
    """The JAX package's greedy rows: its prefill over the padded batch,
    then ``steps - 1`` decode steps fed the argmax."""
    jcfg = jdec.decoder_config_for("pw-tiny-decoder")
    lens = np.array([len(p) for p in prompts])
    ids = np.zeros((len(prompts), 16), np.int64)
    for i, p in enumerate(prompts):
        ids[i, : len(p)] = p
    logits, kc, vc = J_PREFILL(jtree, _j(ids), _j(lens), jcfg, 64)
    out = [np.asarray(logits).argmax(-1)]
    for t in range(steps - 1):
        logits, kc, vc = J_DECODE(jtree, kc, vc, _j(out[-1]), _j(lens + t), jcfg)
        out.append(np.asarray(logits).argmax(-1))
    return np.stack(out, axis=1).tolist()


def test_adapted_greedy_matches_jax_through_both_entry_points(dense_trees):
    """Greedy tokens of the adapted tree through ``generate_ids`` and through
    ``GenerationScheduler`` equal the JAX package's greedy rows, and differ
    from the base tree's."""
    jbase, tbase, jad, tad = dense_trees
    tlm = tdec.DecoderLM("pw-tiny-decoder", max_cache=64, eos_id=None, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, n).tolist() for n in (3, 11, 7)]
    tlm.params = tad
    want = _jax_greedy(jad, prompts, 8)
    assert tlm.generate_ids(prompts, max_new_tokens=8) == want
    sched = generation.GenerationScheduler(tlm, slots=2, page_size=16, prefill_chunk=8)
    try:
        got = [f.result(timeout=120) for f in [sched.submit_ids(p, max_new_tokens=8) for p in prompts]]
    finally:
        sched.shutdown()
    assert got == want
    tlm.params = tbase
    assert tlm.generate_ids(prompts, max_new_tokens=8) != want


@pytest.mark.parametrize("path", ["prefill", "decode_chunk", "paged", "verify_block"])
def test_every_path_runs_the_adapters(dense_trees, path):
    """Each serving path over the adapted tree gives the merged tree's
    logits (2e-5) and not the base tree's: the ``_mm`` branch is on it."""
    _, tbase, _, tad = dense_trees
    cfg = tdec.decoder_config_for("pw-tiny-decoder")
    merged = tlora.merge_lora(tad)
    ids, lens = _t(_ids(4)), _t([9, 4])

    def run(tree):
        if path == "prefill":
            return tdec.prefill(tree, ids, lens, cfg, 16)[0]
        logits, kc, vc = tdec.prefill(tree, ids, lens, cfg, 32)
        if path == "decode_chunk":
            gen = torch.Generator().manual_seed(0)
            done = torch.zeros(2, dtype=torch.bool)
            return tdec.decode_chunk(tree, kc, vc, logits, lens.clone(), done, gen, 1.0, cfg, 4, True, None)[2]
        if path == "verify_block":
            return tdec.verify_block(tree, kc, vc, _t(_ids(5, S=4)), lens, cfg)[0]
        page, G = 4, 4
        bt = _t((1 + np.arange(2 * G)).reshape(2, G))
        kp, vp = tdec.init_kv_pool(cfg, 1 + 2 * G, page, "cpu")
        out, kp, vp = tdec.paged_prefill_chunk(tree, kp, vp, bt, ids, lens, _t([0, 0]), cfg)
        return tdec.paged_decode_step(tree, kp, vp, bt, lens, out.argmax(-1), cfg)[0]

    got = run(tad)
    np.testing.assert_allclose(_np(got), _np(run(merged)), **MERGE_TOL)
    assert np.abs(_np(got) - _np(run(tbase))).max() > 1e-3


# ---------------------------------------------------------------------------
# merge_lora, lora_mask and the trees that refuse adapters
# ---------------------------------------------------------------------------


def test_merge_matches_jax_and_the_adapted_forward(trees):
    name, _, _, jad, tad = trees
    tcfg = tdec.decoder_config_for(name)
    jm = jax.device_get(jlora.merge_lora(jax.tree_util.tree_map(jnp.asarray, jad)))
    tm = tlora.merge_lora(tad)
    for leaf_name, jleaf in jm["layers"].items():
        got = tm["layers"][leaf_name]
        assert not isinstance(got, dict) or leaf_name not in jlora.DEFAULT_TARGETS
        if leaf_name in jlora.DEFAULT_TARGETS:
            assert got.dtype == tad["layers"][leaf_name]["w"].dtype
            np.testing.assert_allclose(_np(got), np.asarray(jleaf, np.float32), rtol=1e-6, atol=1e-6)
        else:
            assert got is tad["layers"][leaf_name]
    ids, lens = _t(_ids(2)), _t([9, 9])
    np.testing.assert_allclose(_np(tdec.prefill(tm, ids, lens, tcfg, 16)[0]),
                               _np(tdec.prefill(tad, ids, lens, tcfg, 16)[0]), **MERGE_TOL)


def test_mask_matches_jax(trees):
    _, _, _, jad, tad = trees
    ref = jlora.lora_mask(jax.tree_util.tree_map(jnp.asarray, jad))
    got = tlora.lora_mask(tad)
    assert got == ref
    assert got["layers"]["wq"] == {"w": False, "a": True, "b": True}
    assert got["embed"] is False and got["layers"]["wk"] is False


def test_quantize_and_speculative_ask_for_merge_lora(dense_trees):
    jbase, tbase, jad, tad = dense_trees
    with pytest.raises(ValueError) as ref:
        jdec.quantize_decoder_tree(jax.tree_util.tree_map(jnp.asarray, jad))
    with pytest.raises(ValueError, match="merge_lora") as got:
        tdec.quantize_decoder_tree(tad)
    # the same text, but for which adapted weight it names first
    assert str(got.value).split("'")[2] == str(ref.value).split("'")[2]
    lm = tdec.DecoderLM("pw-tiny-decoder", max_cache=64, eos_id=None, device="cpu")
    lm.params = tad
    with pytest.raises(ValueError, match="merge_lora"):
        lm.generate_ids_speculative([[1, 2]], max_new_tokens=4)
    # merged trees quantize and draft fine
    assert isinstance(tdec.quantize_decoder_tree(tlora.merge_lora(tad))["layers"]["wq"], dict)
    lm.params = tlora.merge_lora(tad)
    assert lm.generate_ids_speculative([[1, 2]], max_new_tokens=4) == lm.generate_ids([[1, 2]], max_new_tokens=4)

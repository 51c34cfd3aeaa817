"""The port's weight-only int8 decoder against the JAX package's.

``pw-tiny-decoder`` and ``pw-tiny-moe-decoder`` (f32, 4 experts, top-2):
the JAX init is quantized by the JAX ``quantize_decoder_tree`` and carried
into the port with ``from_jax_decoder_params`` (int8 codes stay
``torch.int8``, scales f32); inputs come from numpy with a seed; the port
runs on the CPU.  Pins: int8 codes equal to the JAX package's and scales
within one f32 ulp; the int8 ``_mm`` and the prefill, decode and paged
logits and caches at the JAX decoder pin (rtol/atol 2e-4,
``tests/test_decoder.py``); greedy tokens exactly.  The per-matrix int8 init is held bit for bit
to ``quantize_decoder_tree`` of the float init of the same seed.
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
NAMES = {"dense": "pw-tiny-decoder", "moe": "pw-tiny-moe-decoder"}
# the int8 trees the forward tests run: kind → model
KINDS = {"dense_int8": "dense", "moe_int8": "moe"}
J_INIT = jax.jit(jdec.init_decoder_params, static_argnums=(0, 1))
J_QUANT = jax.jit(jdec.quantize_decoder_tree)
J_PREFILL = jax.jit(jdec.prefill, static_argnums=(3, 4))
J_DECODE = jax.jit(jdec.decode_step, static_argnums=(5,))
J_CHUNK = jax.jit(jdec.paged_prefill_chunk, static_argnums=(7,))
J_STEP = jax.jit(jdec.paged_decode_step, static_argnums=(6,))


def _cfgs(model):
    return jdec.decoder_config_for(NAMES[model]), tdec.decoder_config_for(NAMES[model])


@pytest.fixture(scope="module")
def float_trees():
    """The JAX float init of each model (seed 1), as numpy."""
    return {m: jax.device_get(J_INIT(_cfgs(m)[0], 1)) for m in NAMES}


@pytest.fixture(scope="module")
def trees(float_trees):
    """kind → (the JAX int8 tree, the port's tree carried across)."""
    out = {}
    for kind, model in KINDS.items():
        jtree = jax.device_get(J_QUANT(float_trees[model]))
        out[kind] = (jtree, tdec.from_jax_decoder_params(jtree, _cfgs(model)[1], "cpu"))
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64))


def _j(a):
    return jnp.asarray(a, jnp.int32)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", sorted(NAMES))
def test_codes_and_scales_match_jax(float_trees, model):
    """The port's ``quantize_decoder_tree`` of the same float tree: every
    code equal, every scale within one f32 ulp; embedding, norms and the
    router are the very tensors it was given."""
    _, tc = _cfgs(model)
    ttree = tdec.from_jax_decoder_params(float_trees[model], tc, "cpu")
    got = _leaves(tdec.quantize_decoder_tree(ttree))
    want = _leaves(jax.device_get(J_QUANT(float_trees[model])))
    assert set(got) == set(want)
    quantized = {p for p in got if p.endswith(("/q", "/s"))}
    names = {"lm_head", *(f"layers/{n}" for n in tdec.QUANT_NAMES)}
    assert {p.rsplit("/", 1)[0] for p in quantized} == names
    for path in quantized:
        g, w = got[path].numpy(), np.asarray(want[path])
        assert g.shape == w.shape, path
        if path.endswith("/q"):
            assert g.dtype == np.int8
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            assert g.dtype == np.float32
            ulps = np.abs(g.view(np.int32).astype(np.int64) - w.view(np.int32).astype(np.int64))
            assert ulps.max() <= 1, path
    flat = _leaves(ttree)
    for path in set(got) - quantized:
        assert got[path] is flat[path], path


def test_quantized_weights_roundtrip_within_half_a_scale(float_trees):
    _, tc = _cfgs("dense")
    ttree = tdec.from_jax_decoder_params(float_trees["dense"], tc, "cpu")
    q = tdec.quantize_decoder_tree(ttree)["layers"]["wq"]
    deq = q["q"].float() * q["s"]
    assert bool(((deq - ttree["layers"]["wq"]).abs() <= 0.5 * q["s"] + 1e-8).all())
    assert q["s"].shape == (tc.layers, 1, tc.heads * tc.head_dim)


def test_quantize_matrix_edge_values():
    """Round half to even, the ±127 clip and the 1e-12 floor of an all-zero
    column, as the JAX quantizer does."""
    w = np.array([[127.0, 0.0, -2.54], [63.5, 0.0, 1.27], [-64.5, 0.0, 0.635]], np.float32)
    q, s = tdec._quant_matrix(torch.from_numpy(w))
    jq = J_QUANT({"embed": w, "final_norm": w[0], "lm_head": w, "layers": {}})["lm_head"]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq["q"]))
    np.testing.assert_allclose(s.numpy(), np.asarray(jq["s"]), rtol=1e-7)
    assert q[1, 0] == 64 and q[2, 0] == -64 and s[0, 1] == np.float32(1e-12)


@pytest.mark.parametrize("model", sorted(NAMES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_quantizes_each_matrix_as_quantize_tree(model, dtype):
    """``init_decoder_params(quantize="int8")`` draws and quantizes one
    matrix at a time; its codes and scales are bit for bit those of
    ``quantize_decoder_tree`` over the float init of the same seed (in bf16
    the draws are rounded to bf16 first in both)."""
    tc = dataclasses.replace(_cfgs(model)[1], dtype=dtype)
    direct = _leaves(tdec.init_decoder_params(tc, seed=3, device="cpu", quantize="int8"))
    via_tree = _leaves(tdec.quantize_decoder_tree(tdec.init_decoder_params(tc, seed=3, device="cpu")))
    assert set(direct) == set(via_tree)
    for path, w in direct.items():
        assert w.dtype == via_tree[path].dtype, path
        assert torch.equal(w, via_tree[path]), path


def test_from_jax_params_keeps_int8_and_counts_params(trees):
    jtree, ttree = trees["moe_int8"]
    assert ttree["layers"]["wg"]["q"].dtype == torch.int8
    assert ttree["layers"]["wg"]["s"].dtype == torch.float32
    assert ttree["layers"]["moe_router"].dtype == torch.float32
    assert ttree["embed"].dtype == torch.float32
    np.testing.assert_array_equal(ttree["lm_head"]["q"].numpy(), np.asarray(jtree["lm_head"]["q"]))
    jn = sum(int(np.prod(np.shape(x))) for x in jax.tree_util.tree_leaves(jtree))
    tn = sum(int(w.numel()) for w in _leaves(ttree).values())
    assert tn == jn


def test_value_errors():
    with pytest.raises(ValueError, match="int8"):
        tdec.DecoderLM("pw-tiny-decoder", quantize="fp4", device="cpu")
    tc = tdec.decoder_config_for("pw-tiny-decoder")
    tree = tdec.init_decoder_params(tc, seed=0, device="cpu")
    tree["layers"]["wq"] = {"w": tree["layers"]["wq"], "a": torch.zeros(2, 64, 4), "b": torch.zeros(2, 4, 64)}
    with pytest.raises(ValueError, match="LoRA adapters .*merge_lora"):
        tdec.quantize_decoder_tree(tree)
    # _mm takes the LoRA leaf: zero adapters give the base product exactly
    x = torch.randn(1, 64, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tdec._mm(x, tdec._layer(tree, 0)["wq"]), x @ tree["layers"]["wq"]["w"][0])


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def test_int8_mm_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(2, 48, 40)).astype(np.float32)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    jq = jax.device_get(J_QUANT({"embed": w[0], "final_norm": w[0, 0], "lm_head": w[0], "layers": {"wq": w}}))
    tq = tdec.from_jax_decoder_params(jq, tdec.decoder_config_for("pw-tiny-decoder"), "cpu")
    for i in range(2):
        got = tdec._mm(torch.from_numpy(x), tdec._layer(tq, i)["wq"])
        want = jdec._mm(jnp.asarray(x), jax.tree.map(lambda a: a[i], jq["layers"]["wq"]))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    got = tdec._mm(torch.from_numpy(x), tq["lm_head"])
    np.testing.assert_allclose(_np(got), _np(jdec._mm(jnp.asarray(x), jq["lm_head"])), **TOL)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_prefill_matches_jax(trees, kind):
    jc, tc = _cfgs(KINDS[kind])
    jtree, ttree = trees[kind]
    rng = np.random.default_rng(2)
    ids = rng.integers(1, jc.vocab_size, size=(3, 16))
    lens = np.array([16, 9, 1])
    jl, jk, jv = J_PREFILL(jtree, _j(ids), _j(lens), jc, 32)
    tl, tk, tv = tdec.prefill(ttree, _t(ids), _t(lens), tc, 32)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_steps_match_jax(trees, kind):
    jc, tc = _cfgs(KINDS[kind])
    jtree, ttree = trees[kind]
    rng = np.random.default_rng(3)
    B, S, C, cut = 2, 12, 32, 4
    ids = rng.integers(1, jc.vocab_size, size=(B, S))
    cutv = np.full(B, cut)
    jl, jk, jv = J_PREFILL(jtree, _j(ids), _j(cutv), jc, C)
    tl, tk, tv = tdec.prefill(ttree, _t(ids), _t(cutv), tc, C)
    for t in range(cut, S):
        pos = np.full(B, t)
        jl, jk, jv = J_DECODE(jtree, jk, jv, _j(ids[:, t]), _j(pos), jc)
        tl, tk, tv = tdec.decode_step(ttree, tk, tv, _t(ids[:, t]), _t(pos), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_paged_steps_match_jax(trees, kind):
    """Chunked paged prefill (chunks of 4 over a ragged batch), then paged
    decode steps fed the greedy tokens: logits and pools at every call."""
    jc, tc = _cfgs(KINDS[kind])
    jtree, ttree = trees[kind]
    lens, chunk, page, G = [7, 2], 4, 4, 4
    S = len(lens)
    rng = np.random.default_rng(4)
    ids = np.zeros((S, max(lens)), np.int64)
    for s, n in enumerate(lens):
        ids[s, :n] = rng.integers(1, jc.vocab_size, n)
    bt = (1 + np.arange(S * G)).reshape(S, G)
    tk, tv = tdec.init_kv_pool(tc, 1 + S * G, page, "cpu")
    jk, jv = jdec.init_kv_pool(jc, 1 + S * G, page)
    logits = None
    for start in range(0, max(lens), chunk):
        cids = np.zeros((S, chunk), np.int64)
        clens = np.array([max(0, min(chunk, n - start)) for n in lens])
        for s in range(S):
            cids[s, : clens[s]] = ids[s, start : start + clens[s]]
        starts = np.full(S, start)
        tl, tk, tv = tdec.paged_prefill_chunk(ttree, tk, tv, _t(bt), _t(cids), _t(clens), _t(starts), tc)
        jl, jk, jv = J_CHUNK(jtree, jk, jv, _j(bt), _j(cids), _j(clens), _j(starts), jc)
        live = clens > 0
        np.testing.assert_allclose(_np(tl)[live], _np(jl)[live], **TOL)
        take = torch.from_numpy((start < np.array(lens)) & (start + chunk >= np.array(lens)))
        logits = tl if logits is None else torch.where(take[:, None], tl, logits)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    pos = np.array(lens)
    for _ in range(4):
        tok = logits.argmax(-1).numpy()
        logits, tk, tv = tdec.paged_decode_step(ttree, tk, tv, _t(bt), _t(pos), _t(tok), tc)
        jl, jk, jv = J_STEP(jtree, jk, jv, _j(bt), _j(pos), _j(tok), jc)
        np.testing.assert_allclose(_np(logits), _np(jl), **TOL)
        pos += 1
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)


def test_quantized_logits_track_float(float_trees, trees):
    """int8 logits stay close to the float model's, as the JAX package pins
    (relative error < 0.07 for the MoE tree)."""
    _, tc = _cfgs("moe")
    rng = np.random.default_rng(5)
    ids, lens = _t(rng.integers(1, tc.vocab_size, size=(2, 8))), _t([8, 8])
    want = tdec.prefill(tdec.from_jax_decoder_params(float_trees["moe"], tc, "cpu"), ids, lens, tc, 16)[0]
    got = tdec.prefill(trees["moe_int8"][1], ids, lens, tc, 16)[0]
    assert float((got - want).norm() / want.norm()) < 0.07


# ---------------------------------------------------------------------------
# DecoderLM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_greedy_generate_ids_matches_jax(kind, monkeypatch):
    """``DecoderLM(quantize="int8")`` with the JAX LM's own int8 weights: the same greedy tokens, and the same param count.
    No checkpoint is looked up (``transformers`` is made unimportable, so
    the JAX loader returns ``None`` at once)."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    model = KINDS[kind]
    jlm = jdec.DecoderLM(NAMES[model], max_cache=64, eos_id=None, quantize="int8")
    tlm = tdec.DecoderLM(NAMES[model], max_cache=64, eos_id=None, quantize="int8", device="cpu")
    assert tlm.quantized and not tlm.pretrained
    assert tlm.n_params() == jlm.n_params()
    tlm.params = tdec.from_jax_decoder_params(jax.device_get(jlm.params), tlm.config, "cpu")
    prompts = [[5, 9, 17, 3], [7], [11, 2, 4, 8, 30, 31]]
    assert tlm.generate_ids(prompts, max_new_tokens=8) == jlm.generate_ids(prompts, max_new_tokens=8)


def test_int8_lm_serves_through_the_scheduler():
    """The continuous-batching scheduler over an int8 MoE model gives the
    dense path's greedy tokens; ``shared_scheduler`` passes ``quantize``."""
    from pathway_tpu_torch.serving import generation as gen

    lm = tdec.DecoderLM("pw-tiny-moe-decoder", max_cache=64, eos_id=None, quantize="int8", device="cpu")
    sched = gen.GenerationScheduler(lm, slots=2, page_size=4, prefill_chunk=4)
    try:
        futs = [sched.submit_ids(p, max_new_tokens=6) for p in ([5, 9, 17, 3, 8], [7, 1])]
        got = [f.result(timeout=60) for f in futs]
    finally:
        sched.shutdown()
    assert got == lm.generate_ids([[5, 9, 17, 3, 8], [7, 1]], max_new_tokens=6)
    assert sched.snapshot()["pages_used"] == 0
    shared = gen.shared_scheduler("pw-tiny-decoder", max_cache=64, quantize="int8", device="cpu")
    try:
        assert shared.lm.quantized and isinstance(shared.lm.params["lm_head"], dict)
    finally:
        gen.reset_shared_schedulers()

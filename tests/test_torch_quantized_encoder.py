"""The port's W8A8 encoder serving against the JAX package's.

``quantize_encoder_tree`` must give the JAX package's int8 codes (round
half to even on both sides) and scales, ``_qdot`` the JAX product, and
the quantized encoder the JAX W8A8 embeddings (cosine > 0.999) and, like
the JAX package's own pin, its bf16 embeddings (cosine > 0.99,
``tests/test_quantized_encoder.py:49``).  Small shape: 2 layers, H=128,
4 heads, ffn 512, vocab 1000, given through a ``config.json`` directory.
"""

from __future__ import annotations

import contextlib
import json
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from pathway_tpu.models import encoder as jenc  # noqa: E402
from pathway_tpu_torch.models import encoder as tenc  # noqa: E402

SMALL = {
    "vocab_size": 1000,
    "hidden_size": 128,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "intermediate_size": 512,
    "max_position_embeddings": 128,
}
QUANTIZED = ("qkv_k", "out_k", "ff1_k", "ff2_k")


@contextlib.contextmanager
def no_transformers():
    saved = sys.modules.get("transformers", "absent")
    sys.modules["transformers"] = None
    try:
        yield
    finally:
        if saved == "absent":
            del sys.modules["transformers"]
        else:
            sys.modules["transformers"] = saved


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("small_w8a8_encoder")
    (d / "config.json").write_text(json.dumps(SMALL))
    return str(d)


@pytest.fixture(scope="module")
def trees(model_dir):
    """The JAX package's packed tree and the port's, from one JAX init."""
    cfg = jenc.config_for(model_dir)
    params = jenc.SentenceEncoderModule(cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32)
    )
    params = jax.device_get(params)
    tcfg = tenc.config_for(model_dir)
    return cfg, jenc.pack_fast_params(params, cfg), tcfg, tenc.from_jax_params(params, tcfg, "cpu")


def _cos_rows(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_codes_and_scales_match_jax(trees):
    _, jtree, _, ttree = trees
    jq = jenc.quantize_encoder_tree(jtree)
    tq = tenc.quantize_encoder_tree(ttree)
    for jl, tl, orig in zip(jq["layers"], tq["layers"], ttree["layers"]):
        for key in QUANTIZED:
            q, s = tl[key]["q"], tl[key]["s"]
            assert q.dtype == torch.int8 and s.dtype == torch.float32, key
            assert q.shape == jl[key]["q"].shape and s.shape == jl[key]["s"].shape, key
            np.testing.assert_array_equal(q.numpy(), np.asarray(jl[key]["q"]), err_msg=key)
            np.testing.assert_allclose(s.numpy(), np.asarray(jl[key]["s"]), rtol=2**-23, atol=0, err_msg=key)
            # the column-major second operand torch._int_mm takes on CUDA
            assert q.stride() == (1, q.shape[0]), key
        for key in set(tl) - set(QUANTIZED):  # biases and layernorms untouched
            assert tl[key] is orig[key], key
    assert tq["emb_word"] is ttree["emb_word"]


def test_codes_round_half_to_even():
    # a column whose max is 127 gives the scale 1.0 exactly, so w/s = w
    w = torch.tensor([[0.5, 0.0], [1.5, 0.0], [2.5, 0.0], [-0.5, 0.0], [127.0, 1.0]], dtype=torch.float32)
    q = tenc.quantize_encoder_tree({"layers": [{k: w for k in QUANTIZED}]})["layers"][0]["qkv_k"]
    assert q["q"][:, 0].tolist() == [0, 2, 2, 0, 127]
    ref = jenc.quantize_encoder_tree({"layers": [{k: jnp.asarray(w.numpy()) for k in QUANTIZED}]})
    np.testing.assert_array_equal(q["q"].numpy(), np.asarray(ref["layers"][0]["qkv_k"]["q"]))
    # an all-zero column keeps the 1e-12 floor, not a division by zero
    zero = tenc.quantize_encoder_tree({"layers": [{k: torch.zeros(8, 3) for k in QUANTIZED}]})
    assert float(zero["layers"][0]["ff1_k"]["s"].min()) == pytest.approx(1e-12)
    assert int(zero["layers"][0]["ff1_k"]["q"].abs().max()) == 0


@pytest.mark.parametrize("rows", [5, 16, 17, 96], ids=lambda r: f"rows{r}")
def test_qdot_matches_jax(trees, rows):
    _, jtree, _, ttree = trees
    rng = np.random.default_rng(rows)
    x = (rng.normal(size=(rows, 128)) * rng.uniform(0.1, 4.0, size=(rows, 1))).astype(np.float32)
    x[0] = 0.0  # an all-zero row keeps the 1e-8 floor
    jw = jenc.quantize_encoder_tree(jtree)["layers"][0]["ff1_k"]
    tw = tenc.quantize_encoder_tree(ttree)["layers"][0]["ff1_k"]
    ref = jenc._qdot(jnp.asarray(x, jnp.bfloat16), jw)
    out = tenc._qdot(torch.from_numpy(x).to(torch.bfloat16), tw)
    assert out.dtype == torch.bfloat16 and out.shape == (rows, 512)
    # integer sums are exact and the scales equal: the same bf16 values
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))
    assert (out[0] == 0).all()
    # a float weight is the plain product
    plain = ttree["layers"][0]["ff1_k"]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(tenc._qdot(xb, plain), xb @ plain)


def _ragged_batch(B=6, S=32, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(104, SMALL["vocab_size"], size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 20:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = 0
    return ids, mask


def test_w8a8_embeddings_match_jax_and_bf16(trees):
    cfg, jtree, tcfg, ttree = trees
    ids, mask = _ragged_batch()
    ref = np.asarray(
        jenc.fused_sentence_apply(jenc.quantize_encoder_tree(jtree), jnp.asarray(ids), jnp.asarray(mask), cfg),
        np.float32,
    )
    with torch.inference_mode():
        ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
        out = tenc.fused_sentence_apply(tenc.quantize_encoder_tree(ttree), ids_t, mask_t, tcfg).numpy()
        bf16 = tenc.fused_sentence_apply(ttree, ids_t, mask_t, tcfg).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-3)
    assert _cos_rows(out, ref).min() > 0.999
    assert _cos_rows(out, bf16).min() > 0.99


def test_quantized_sentence_encoder_matches_jax(model_dir):
    texts = ["hello world", "quantized serving on the card", "a b c d e f g h i j k"]
    with no_transformers():
        jq = jenc.SentenceEncoder(model_dir, max_batch=8, quantize="int8")
        tq = tenc.SentenceEncoder(model_dir, max_batch=8, quantize="int8", device="cpu")
        tf = tenc.SentenceEncoder(model_dir, max_batch=8, device="cpu")
    tq.set_params(jax.device_get(jq.params))
    tf.set_params(jax.device_get(jq.params))
    assert tq._quantize == "int8" and isinstance(tq.model.tree()["layers"][0]["qkv_k"], dict)
    out, ref, bf16 = tq.encode(texts), np.asarray(jq.encode(texts)), tf.encode(texts)
    assert _cos_rows(out, ref).min() > 0.999
    assert _cos_rows(out, bf16).min() > 0.99


def test_quantize_env_and_argument(model_dir, monkeypatch):
    with no_transformers():
        monkeypatch.setenv("PATHWAY_ENCODER_QUANTIZE", "int8")
        assert tenc.SentenceEncoder(model_dir, max_batch=8, device="cpu")._quantize == "int8"
        # rerankers quantize only by explicit opt-in (score fidelity unpinned)
        assert tenc.CrossEncoder(model_dir, max_batch=8, device="cpu")._quantize is None
        ce = tenc.CrossEncoder(model_dir, max_batch=8, quantize="int8", device="cpu")
        assert ce._quantize == "int8" and np.isfinite(ce.score([("q", "a doc")])).all()
        monkeypatch.setenv("PATHWAY_ENCODER_QUANTIZE", "")
        assert tenc.SentenceEncoder(model_dir, max_batch=8, device="cpu")._quantize is None
        monkeypatch.delenv("PATHWAY_ENCODER_QUANTIZE")
        assert tenc.SentenceEncoder(model_dir, max_batch=8, device="cpu")._quantize is None
        with pytest.raises(ValueError, match="int8"):
            tenc.SentenceEncoder(model_dir, quantize="fp4", device="cpu")
        monkeypatch.setenv("PATHWAY_ENCODER_QUANTIZE", "fp4")
        with pytest.raises(ValueError, match="int8"):
            tenc.SentenceEncoder(model_dir, device="cpu")
        monkeypatch.delenv("PATHWAY_ENCODER_QUANTIZE")
        monkeypatch.setenv("PATHWAY_FUSED_ENCODER", "0")
        with pytest.raises(ValueError, match="fused"):
            tenc.SentenceEncoder(model_dir, quantize="int8", device="cpu")

"""The port's Flax module forward (``PATHWAY_FUSED_ENCODER=0``) against
Flax ``module.apply``, for ``SentenceEncoderModule`` and
``CrossEncoderModule``, on the same Flax param tree.

In f32 the two packages compute the same function in the same type, so the
pin is tight: max abs err < 1e-4, the JAX package's own module-vs-torch
pin (``tests/test_model_parity.py``).  In bf16 embeddings agree at cosine
> 0.999 (``tests/test_attention_kernel.py:119``) and scores within
0.05·(max|ref|+1) (``:135``).  Batches carry padded tails and an
all-padding row.  Small shape: 2 layers, H=128, 4 heads, ffn 512, vocab
1000.
"""

from __future__ import annotations

import dataclasses
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
F32_TOL = 1e-4


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("small_module_encoder")
    (d / "config.json").write_text(json.dumps(SMALL))
    return str(d)


def _configs(model_dir, dtype):
    j = jenc.config_for(model_dir)
    t = tenc.config_for(model_dir)
    if dtype == "float32":
        return dataclasses.replace(j, dtype=jnp.float32), dataclasses.replace(t, dtype=torch.float32)
    return j, t


def _init(module_cls, cfg, seed):
    params = module_cls(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32)
    )
    return jax.device_get(params)


def _batch(B=5, S=32, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(104, SMALL["vocab_size"], size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 20:] = 0
    mask[2, 3:] = 0
    mask[4, :] = 0  # an all-padding row, as the executor's batch padding makes
    ids[mask == 0] = 0
    return ids, mask


def _cos_rows(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sentence_module_matches_flax(model_dir, dtype, pooling):
    jcfg, tcfg = _configs(model_dir, dtype)
    jcfg, tcfg = dataclasses.replace(jcfg, pooling=pooling), dataclasses.replace(tcfg, pooling=pooling)
    params = _init(jenc.SentenceEncoderModule, jcfg, seed=2)
    ids, mask = _batch()
    ref = np.asarray(jenc.SentenceEncoderModule(jcfg).apply(params, jnp.asarray(ids), jnp.asarray(mask)), np.float32)
    module = tenc.SentenceEncoderModule(tcfg, params)
    with torch.inference_mode():
        out = module(torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    out = out.numpy()
    assert np.isfinite(out).all()
    real = mask.sum(1) > 0
    if dtype == "float32":
        assert np.abs(out - ref).max() < F32_TOL
    else:
        assert _cos_rows(out[real], ref[real]).min() > 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_module_matches_flax(model_dir, dtype):
    jcfg, tcfg = _configs(model_dir, dtype)
    params = _init(jenc.CrossEncoderModule, jcfg, seed=3)
    ids, mask = _batch(seed=1)
    ref = np.asarray(jenc.CrossEncoderModule(jcfg).apply(params, jnp.asarray(ids), jnp.asarray(mask)), np.float32)
    module = tenc.CrossEncoderModule(tcfg, params)
    with torch.inference_mode():
        out = module(torch.from_numpy(ids), torch.from_numpy(mask))
        trunk = module.Encoder_0(torch.from_numpy(ids), torch.from_numpy(mask)).float().numpy()
    assert out.dtype == torch.float32 and out.shape == ref.shape == (ids.shape[0],)
    out = out.numpy()
    ref_trunk = np.asarray(
        jenc.Encoder(jcfg).apply({"params": params["params"]["Encoder_0"]}, jnp.asarray(ids), jnp.asarray(mask)),
        np.float32,
    )
    valid = mask.astype(bool)
    if dtype == "float32":
        assert np.abs(out - ref).max() < F32_TOL
        assert np.abs(trunk - ref_trunk)[valid].max() < F32_TOL
    else:
        assert np.abs(out - ref).max() < 0.05 * (np.abs(ref).max() + 1.0)
        assert _cos_rows(trunk[valid], ref_trunk[valid]).min() > 0.999


def test_module_holds_the_flax_tree(model_dir):
    jcfg, tcfg = _configs(model_dir, "bfloat16")
    params = _init(jenc.CrossEncoderModule, jcfg, seed=0)
    module = tenc.CrossEncoderModule(tcfg, params)
    names = set(module.state_dict())
    assert "Encoder_0.TransformerBlock_1.MultiHeadDotProductAttention_0.query.kernel" in names
    assert {"Dense_0.kernel", "Dense_1.bias", "Encoder_0.Embed_0.embedding"} <= names
    leaves = jax.tree_util.tree_leaves(params)
    assert len(names) == len(leaves)
    # parameters stay f32, as Flax keeps them; the computation runs in bf16
    assert all(t.dtype == torch.float32 for t in module.state_dict().values())


def test_fused_off_selects_the_module_path(model_dir, monkeypatch):
    saved = sys.modules.get("transformers", "absent")
    sys.modules["transformers"] = None  # seeded weights, hashing tokenizer
    try:
        monkeypatch.setenv("PATHWAY_FUSED_ENCODER", "0")
        enc = tenc.SentenceEncoder(model_dir, max_batch=8, device="cpu")
        ce = tenc.CrossEncoder(model_dir, max_batch=8, device="cpu")
        monkeypatch.delenv("PATHWAY_FUSED_ENCODER")
        fused = tenc.SentenceEncoder(model_dir, max_batch=8, device="cpu")
    finally:
        if saved == "absent":
            del sys.modules["transformers"]
        else:
            sys.modules["transformers"] = saved
    assert not enc._fused and isinstance(enc.model, tenc.SentenceEncoderModule)
    assert not ce._fused and isinstance(ce.model, tenc.CrossEncoderModule)
    assert fused._fused and isinstance(fused.model, tenc.FusedSentenceEncoder)
    texts = ["streaming dataflow on the card", "a second text", "x"]
    emb = enc.encode(texts)
    ids, mask = tenc.pad_batch([enc.tokenizer.encode(t) for t in texts], 16)
    with torch.inference_mode():
        direct = enc.model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(emb, direct, atol=1e-6)
    # the module path and the fused path compute the same embeddings, up
    # to the fused path's bf16 rounding and tanh GELU
    assert _cos_rows(emb, fused.encode(texts)).min() > 0.99
    scores = ce.score([("q", "a document"), ("another query", "x y z")])
    assert scores.shape == (2,) and np.isfinite(scores).all()
    # set_params keeps the path
    enc.set_params(enc.params)
    assert isinstance(enc.model, tenc.SentenceEncoderModule)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
@pytest.mark.parametrize("cls", ["SentenceEncoder", "CrossEncoder"])
def test_fused_off_refuses_a_card(model_dir, monkeypatch, cls, device):
    # the module forward's attention is the plain one, not the card's
    # kernel: it stays a host parity path, and a CUDA device (the default
    # included) raises before anything is built
    monkeypatch.setenv("PATHWAY_FUSED_ENCODER", "0")
    with pytest.raises(ValueError, match="PATHWAY_FUSED_ENCODER=0"):
        getattr(tenc, cls)(model_dir, max_batch=8, device=device)

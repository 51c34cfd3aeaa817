"""The port's sentence encoder against the JAX package's fused path.

Small shape (2 layers, H=128, 4 heads so hd=32, ffn 512, vocab 1000), given
to both packages through a ``config.json`` directory.  Inputs come from
numpy with a seed; weights are carried from the JAX tree into the port.
"""

from __future__ import annotations

import json

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


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("small_encoder")
    (d / "config.json").write_text(json.dumps(SMALL))
    return str(d)


@pytest.fixture(scope="module")
def jax_params(model_dir):
    cfg = jenc.config_for(model_dir)
    module = jenc.SentenceEncoderModule(cfg)
    params = module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32)
    )
    return cfg, jax.device_get(params)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(np.shape(v))
    return out


def test_config_for_reads_config_json(model_dir):
    j = jenc.config_for(model_dir)
    t = tenc.config_for(model_dir)
    for field in ("vocab_size", "hidden", "layers", "heads", "intermediate", "max_len", "pooling"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["all-MiniLM-L6-v2", "BAAI/bge-base-en-v1.5", "mixedbread-ai/mxbai-embed-large-v1"])
def test_presets_match(name):
    j, t = jenc.config_for(name), tenc.config_for(name)
    assert (t.hidden, t.layers, t.heads, t.intermediate, t.pooling) == (
        j.hidden, j.layers, j.heads, j.intermediate, j.pooling
    )


def test_seeded_init_has_the_flax_structure(jax_params):
    cfg, params = jax_params
    tcfg = tenc.EncoderConfig(**{f: getattr(cfg, f) for f in ("vocab_size", "hidden", "layers", "heads", "intermediate", "max_len")})
    ours = tenc.init_params(tcfg, seed=0)
    assert _paths(ours) == _paths(params)
    enc = ours["params"]["Encoder_0"]
    H = cfg.hidden
    # Flax-like distributions: embeddings std 1/sqrt(H), LeCun kernels 1/sqrt(fan_in)
    assert abs(enc["Embed_0"]["embedding"].std() - 1 / np.sqrt(H)) < 0.1 / np.sqrt(H)
    ff1 = enc["TransformerBlock_0"]["Dense_0"]["kernel"]
    assert abs(ff1.std() - 1 / np.sqrt(H)) < 0.1 / np.sqrt(H)
    assert np.abs(ff1).max() <= 2.0 / 0.87962566103423978 / np.sqrt(H) + 1e-6
    assert (enc["LayerNorm_0"]["scale"] == 1).all() and (enc["LayerNorm_0"]["bias"] == 0).all()
    again = tenc.init_params(tcfg, seed=0)
    assert np.array_equal(again["params"]["Encoder_0"]["Embed_0"]["embedding"], enc["Embed_0"]["embedding"])


def test_pack_matches_jax_pack_bitwise(jax_params):
    cfg, params = jax_params
    tcfg = tenc.EncoderConfig(hidden=cfg.hidden, layers=cfg.layers, heads=cfg.heads,
                              intermediate=cfg.intermediate, vocab_size=cfg.vocab_size,
                              max_len=cfg.max_len)
    ref = jenc.pack_fast_params(params, cfg)
    ours = tenc.pack_fast_params(params, tcfg)
    for key in ("emb_word", "emb_pos", "eln_s", "eln_b"):
        assert ours[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(ours[key]), _np(ref[key]), err_msg=key)
    for lt, lj in zip(ours["layers"], ref["layers"]):
        assert set(lt) == set(lj)
        for key in lj:
            np.testing.assert_array_equal(_np(lt[key]), _np(lj[key]), err_msg=key)


def test_from_jax_params_round_trip(model_dir):
    """The JAX encoder's own params, carried across, give the tree the JAX
    encoder runs (``_infer_params``), value for value."""
    import sys

    saved = sys.modules.get("transformers", "absent")
    sys.modules["transformers"] = None  # no checkpoint lookup: seeded init only
    try:
        j = jenc.SentenceEncoder(model_dir)
    finally:
        if saved == "absent":
            del sys.modules["transformers"]
        else:
            sys.modules["transformers"] = saved
    tree = tenc.from_jax_params(jax.device_get(j.params), tenc.config_for(model_dir), "cpu")
    ref = j._infer_params
    np.testing.assert_array_equal(_np(tree["emb_word"]), _np(ref["emb_word"]))
    for lt, lj in zip(tree["layers"], ref["layers"]):
        for key in lj:
            np.testing.assert_array_equal(_np(lt[key]), _np(lj[key]), err_msg=key)
    model = tenc.FusedSentenceEncoder(tree, tenc.config_for(model_dir))
    back = model.tree()
    assert back["emb_pos"] is tree["emb_pos"] and len(back["layers"]) == len(tree["layers"])


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_ln_matches_jax(dtype, tol):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 128)).astype(np.float32) * 3 + 1.5
    if dtype == "bfloat16":
        # a near-constant row (|mean| >> spread), where centring before
        # squaring matters; in f32 such a row only amplifies the two sides'
        # different summation orders, so the f32 check keeps well-scaled rows
        x[0] = 7.0 + rng.normal(size=128) * 1e-2
    scale = rng.normal(size=128).astype(np.float32)
    bias = rng.normal(size=128).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jenc._ln(jnp.asarray(x, jd), jnp.asarray(scale, jd), jnp.asarray(bias, jd))
    out = tenc._ln(torch.from_numpy(x).to(td), torch.from_numpy(scale).to(td), torch.from_numpy(bias).to(td))
    assert out.dtype == td
    err = np.abs(_np(out) - _np(ref)).max()
    assert err < tol * max(1.0, np.abs(_np(ref)).max()), err


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_pool_matches_jax(pooling):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 16, 128)).astype(np.float32)
    mask = np.ones((3, 16), np.int32)
    mask[1, 9:] = 0
    mask[2, 1:] = 0
    ref = jenc._pool(jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask), pooling)
    out = tenc._pool(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask), pooling)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-2)


def _ragged_batch(cfg, B=4, S=32, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(104, cfg.vocab_size, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 20:] = 0
    mask[2, 5:] = 0
    mask[3, :] = 0  # an all-padding row, as the executor's batch padding makes
    ids[mask == 0] = 0
    return ids, mask


def _cos_rows(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "pallas_interpret"])
def test_fused_sentence_apply_matches_jax(jax_params, model_dir, interpret):
    cfg, params = jax_params
    tcfg = tenc.config_for(model_dir)
    ids, mask = _ragged_batch(cfg)
    ref = np.asarray(
        jenc.fused_sentence_apply(
            jenc.pack_fast_params(params, cfg), jnp.asarray(ids), jnp.asarray(mask), cfg,
            interpret=interpret,
        ),
        np.float32,
    )
    with torch.inference_mode():
        out = tenc.fused_sentence_apply(
            tenc.from_jax_params(params, tcfg, "cpu"),
            torch.from_numpy(ids),
            torch.from_numpy(mask),
            tcfg,
        ).numpy()
    assert out.shape == ref.shape == (ids.shape[0], cfg.hidden)
    assert np.isfinite(out).all()
    real = mask.sum(1) > 0
    # an all-padding row pools to zero in both packages
    np.testing.assert_array_equal(out[~real], 0.0)
    np.testing.assert_array_equal(ref[~real], 0.0)
    cos = _cos_rows(out[real], ref[real])
    assert cos.min() > 0.999, cos

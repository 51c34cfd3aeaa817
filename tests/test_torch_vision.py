"""The port's multimodal dual encoder against the JAX package's.

``pw-tiny-siglip`` (a 2-layer ViT, H 64, 4 heads, patch 8 over 32×32
images, proj 32, f32; the bf16 ``all-MiniLM-L6-v2`` text tower).  The JAX
encoder's three trees (``params``, ``text_params``, ``text_proj``) are
carried into the port; inputs come from numpy with a seed; the port runs on
the CPU.  Pins: the image tower in f32 at max abs err < 1e-4 (the JAX
package's module-vs-torch pin, ``tests/test_model_parity.py``), bf16
towers at cosine > 0.999 (``tests/test_attention_kernel.py:119``), batch
padding at 1e-5 (``tests/test_vision.py:53-59``), host numpy exactly.
"""

from __future__ import annotations

import dataclasses
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from pathway_tpu.models import encoder as jenc_mod  # noqa: E402
from pathway_tpu.models import vision as jv  # noqa: E402
from pathway_tpu_torch.models import encoder as tenc_mod  # noqa: E402
from pathway_tpu_torch.models import vision as tv  # noqa: E402

MODEL = "pw-tiny-siglip"
F32_TOL = 1e-4
JCFG = jv.vision_config_for(MODEL)[0]
TCFG = tv.vision_config_for(MODEL)[0]
J_FORWARD = jax.jit(jv.vision_forward, static_argnums=(2,))


J_INIT = jax.jit(jv.init_vision_params, static_argnums=(0, 1))


@pytest.fixture(scope="module")
def encoders():
    """The JAX package's encoder and the port's, with the JAX trees.  The
    JAX text tower's Flax init runs op by op for seconds; a seeded tree of
    the same structure (the port's ``init_params``) takes its place."""
    text_tree = tenc_mod.init_params(tenc_mod.config_for(jv.VISION_PRESETS[MODEL][1]), seed=1)
    with mock.patch.object(jenc_mod.SentenceEncoderModule, "init",
                           lambda self, *args: jax.tree_util.tree_map(jnp.asarray, text_tree)):
        jenc = jv.MultimodalEncoder(MODEL)
    tenc = tv.MultimodalEncoder(MODEL, device="cpu")
    tenc.from_jax(jax.device_get(jenc.params), jax.device_get(jenc.text_params), np.asarray(jenc.text_proj))
    return jenc, tenc


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _cos_rows(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _images(seed, shape=(5, 32, 32, 3)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Config, weights and the host-side pieces
# ---------------------------------------------------------------------------


def test_presets_match_the_jax_package():
    assert set(tv.VISION_PRESETS) == set(jv.VISION_PRESETS)
    for name, (jc, jtext) in jv.VISION_PRESETS.items():
        tc, ttext = tv.VISION_PRESETS[name]
        assert ttext == jtext, name
        for field in dataclasses.fields(tc):
            if field.name == "dtype":
                assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name, name
            else:
                assert getattr(tc, field.name) == getattr(jc, field.name), (name, field.name)
        assert tc.n_patches == jc.n_patches


def test_unknown_model_raises_the_jax_error():
    with pytest.raises(ValueError, match="unknown multimodal model") as port:
        tv.vision_config_for("siglip-maxi")
    with pytest.raises(ValueError) as ref:
        jv.vision_config_for("siglip-maxi")
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="unknown multimodal model"):
        tv.MultimodalEncoder("siglip-maxi", device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_has_the_jax_tree(dtype):
    """Names, shapes and dtypes leaf for leaf; the draws' scale is
    1/sqrt(fan_in), the LayerNorms ones and zeros, the SigLIP head f32."""
    jcfg = dataclasses.replace(JCFG, dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(TCFG, dtype=getattr(torch, dtype))
    jtree = jax.device_get(J_INIT(jcfg, 0))
    ttree = tv.init_vision_params(tcfg, seed=0, device="cpu")
    jflat = dict(jax.tree_util.tree_flatten_with_path(jtree)[0])
    tflat = dict(jax.tree_util.tree_flatten_with_path(ttree)[0])
    assert set(map(str, jflat)) == set(map(str, tflat))
    for path, leaf in jflat.items():
        got = tflat[path]
        assert tuple(got.shape) == tuple(np.shape(leaf)), path
        assert str(got.dtype).split(".")[-1] == jnp.dtype(leaf.dtype).name, path
    assert float(ttree["logit_scale"]) == pytest.approx(np.log(10.0))
    assert float(ttree["logit_bias"]) == -10.0
    H, pdim = tcfg.hidden, tcfg.patch**2 * 3
    assert float(ttree["patch_k"].float().std()) == pytest.approx(1 / np.sqrt(pdim), rel=0.1)
    assert float(ttree["layers"]["ff2_k"].float().std()) == pytest.approx(1 / np.sqrt(tcfg.intermediate), rel=0.1)
    assert bool((ttree["layers"]["ln0_s"] == 1).all()) and not bool(ttree["layers"]["qkv_b"].any())
    again = tv.init_vision_params(tcfg, seed=0, device="cpu")
    assert torch.equal(again["layers"]["qkv_k"], ttree["layers"]["qkv_k"])
    assert not torch.equal(tv.init_vision_params(tcfg, seed=1, device="cpu")["proj"], ttree["proj"])


def test_jax_tree_carries_across_unchanged():
    jtree = jax.device_get(J_INIT(JCFG, 3))
    ttree = tv.from_jax_vision_params(jtree, TCFG, "cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        got = ttree
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(_np(got), np.asarray(leaf, np.float32))
    bf = tv.from_jax_vision_params(jtree, dataclasses.replace(TCFG, dtype=torch.bfloat16), "cpu")
    assert bf["pos"].dtype == torch.bfloat16 and bf["logit_scale"].dtype == torch.float32


@pytest.mark.parametrize("size", [32, 37])
def test_patchify_matches_jax(size):
    """Exact on arange images; the first patch is the top-left 8×8 block,
    row-major over (row, column, channel).  At 37 pixels (not a multiple of
    the patch) the port drops the last 5 rows and columns, as a
    stride-8 convolution without padding does: the JAX patchify of the
    cropped image."""
    imgs = np.arange(2 * size * size * 3, dtype=np.float32).reshape(2, size, size, 3)
    got = tv.patchify(torch.from_numpy(imgs), TCFG.patch).numpy()
    keep = size // TCFG.patch * TCFG.patch
    ref = np.asarray(jv.patchify(jnp.asarray(imgs[:, :keep, :keep]), JCFG.patch))
    assert got.shape == (2, (size // 8) ** 2, 8 * 8 * 3)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0, 0], imgs[0, :8, :8, :].reshape(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 64)) * 3 + 1).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jv._ln(*(jnp.asarray(a, jd) for a in (x, s, b))).astype(jnp.float32))
    got = tv._ln(*(torch.from_numpy(a).to(td) for a in (x, s, b)))
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-5)
    else:
        # one bf16 rounding step apart at most
        np.testing.assert_allclose(_np(got), ref, rtol=2**-7, atol=2**-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_forward_matches_jax(dtype):
    jcfg = dataclasses.replace(JCFG, dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(TCFG, dtype=getattr(torch, dtype))
    jtree = jax.device_get(J_INIT(jcfg, 1))
    ttree = tv.from_jax_vision_params(jtree, tcfg, "cpu")
    imgs = _images(0) * 2 - 1
    ref = np.asarray(J_FORWARD(jtree, jnp.asarray(imgs), jcfg))
    with torch.inference_mode():
        got = tv.vision_forward(ttree, torch.from_numpy(imgs), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (5, tcfg.proj_dim)
    got = got.numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    if dtype == "float32":
        assert np.abs(got - ref).max() < F32_TOL
    else:
        assert _cos_rows(got, ref).min() > 0.999


def test_pairwise_logits_match_jax():
    rng = np.random.default_rng(2)
    ie, te = (rng.standard_normal((n, 32)).astype(np.float32) for n in (3, 4))
    jtree = {"logit_scale": jnp.float32(np.log(10.0)), "logit_bias": jnp.float32(-10.0)}
    ttree = {"logit_scale": torch.tensor(np.log(10.0), dtype=torch.float32),
             "logit_bias": torch.tensor(-10.0)}
    ref = np.asarray(jv.pairwise_logits(jnp.asarray(ie), jnp.asarray(te), jtree))
    got = tv.pairwise_logits(torch.from_numpy(ie), torch.from_numpy(te), ttree)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("shape,size", [((1, 16, 16, 3), 16), ((2, 16, 16, 3), 32), ((1, 48, 40, 3), 32)])
def test_resize_bilinear_matches_jax(shape, size):
    x = np.random.default_rng(3).random(shape).astype(np.float32)
    got = tv._resize_bilinear(x, size)
    np.testing.assert_array_equal(got, jv._resize_bilinear(x, size))
    assert got.shape == (shape[0], size, size, 3) and got.dtype == np.float32
    assert got.min() >= x.min() - 1e-6 and got.max() <= x.max() + 1e-6
    if shape[1] == size:
        np.testing.assert_allclose(got, x, atol=1e-6)


# ---------------------------------------------------------------------------
# The encoder, end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["float", "uint8", "resized"])
def test_embed_images_matches_jax(encoders, kind, monkeypatch):
    """Six images in batches of at most 4 (buckets 4 and 2) through both
    encoders: float in [0, 1], uint8, and uint8 at 48×40 through the host
    resize."""
    jenc, tenc = encoders
    monkeypatch.setattr(jenc, "max_batch", 4)
    monkeypatch.setattr(tenc, "max_batch", 4)
    rng = np.random.default_rng(4)
    if kind == "float":
        imgs = rng.random((6, 32, 32, 3)).astype(np.float32)
    else:
        shape = (6, 32, 32, 3) if kind == "uint8" else (6, 48, 40, 3)
        imgs = rng.integers(0, 256, size=shape).astype(np.uint8)
    ref = jenc.embed_images(imgs)
    got = tenc.embed_images(imgs)
    assert got.shape == ref.shape == (6, tenc.dimensions) and got.dtype == np.float32
    assert np.abs(got - ref).max() < F32_TOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(tenc.embed_images(imgs[0])[0], got[0], atol=1e-5)  # one [S, S, 3] image


def test_embed_texts_matches_jax(encoders):
    jenc, tenc = encoders
    texts = ["a photo of a cat", "finance report", "", "streaming dataflow with a live index " * 3, "x"]
    ref = jenc.embed_texts(texts)
    got = tenc.embed_texts(texts)
    assert got.shape == ref.shape == (5, tenc.dimensions) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert _cos_rows(got, ref).min() > 0.999
    assert tenc.embed_texts([]).shape == (0, tenc.dimensions)


def test_score_matches_jax(encoders):
    jenc, tenc = encoders
    imgs = _images(5, (2, 32, 32, 3))
    texts = ["one", "two", "three"]
    ref = jenc.score(imgs, texts)
    got = tenc.score(imgs, texts)
    assert got.shape == ref.shape == (2, 3) and np.isfinite(got).all()
    # bf16 text tower: |<i, t> - <i, t'>| <= |t - t'| <= sqrt(2 - 2·0.999)
    assert np.abs(got - ref).max() < 10.0 * np.sqrt(2 - 2 * 0.999)
    ie, te = tenc.embed_images(imgs), tenc.embed_texts(texts)
    np.testing.assert_allclose(got, np.exp(np.log(10.0)) * ie @ te.T - 10.0, rtol=1e-5, atol=1e-5)


def test_batch_padding_invariance(encoders):
    """A row's embedding does not depend on the batch around it."""
    _, tenc = encoders
    imgs = _images(1)
    np.testing.assert_allclose(tenc.embed_images(imgs)[2], tenc.embed_images(imgs[2:3])[0], atol=1e-5)


def test_surface_and_default_device(monkeypatch):
    enc = tv.shared_multimodal_encoder(MODEL, device="cpu")
    assert enc is tv.shared_multimodal_encoder(MODEL, device="cpu")
    assert enc.dimensions == TCFG.proj_dim and enc.device == torch.device("cpu")
    assert enc.text_config.hidden == 384 and enc.text_config.dtype == torch.bfloat16
    assert tuple(enc.text_proj.shape) == (384, TCFG.proj_dim)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.MultimodalEncoder(MODEL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.init_vision_params(TCFG)

"""The port's cross-encoder against the JAX package's.

Small shape (2 layers, H=128, 4 heads so hd=32, ffn 512, vocab 1000), given
to both packages through a ``config.json`` directory.  Inputs come from
numpy with a seed; weights are carried from the JAX tree into the port.
Scores are held to the JAX package's cross-encoder pin, 0.05·(max|ref|+1)
(``tests/test_attention_kernel.py:135``).
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


@contextlib.contextmanager
def no_transformers():
    """No HF checkpoint or tokenizer lookup (the card has no transformers
    either): both packages use the hashing tokenizer and seeded weights."""
    saved = sys.modules.get("transformers", "absent")
    sys.modules["transformers"] = None
    try:
        yield
    finally:
        if saved == "absent":
            del sys.modules["transformers"]
        else:
            sys.modules["transformers"] = saved


def score_tol(ref) -> float:
    return 0.05 * (float(np.max(np.abs(ref))) + 1.0)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("small_cross_encoder")
    (d / "config.json").write_text(json.dumps(SMALL))
    return str(d)


@pytest.fixture(scope="module")
def jax_params(model_dir):
    cfg = jenc.config_for(model_dir)
    module = jenc.CrossEncoderModule(cfg)
    params = module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32)
    )
    return cfg, jax.device_get(params)


@pytest.fixture(scope="module")
def encoders(model_dir):
    with no_transformers():
        jce = jenc.CrossEncoder(model_dir)
        tce = tenc.CrossEncoder(model_dir, device="cpu")
    tce.set_params(jax.device_get(jce.params))
    return jce, tce


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(np.shape(v))
    return out


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _pairs(n, seed=0):
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    words = ["".join(rng.choice(letters, size=int(m))) for m in rng.integers(3, 9, size=500)]
    out = []
    for _ in range(n):
        q = " ".join(rng.choice(words, size=int(rng.integers(2, 8))))
        d = " ".join(rng.choice(words, size=int(rng.integers(5, 40))))
        out.append((q, d))
    return out


def test_seeded_init_has_the_cross_encoder_structure(jax_params):
    _, params = jax_params
    cfg = tenc.EncoderConfig(**{k: v for k, v in zip(
        ("vocab_size", "hidden", "layers", "heads", "intermediate", "max_len"), SMALL.values())})
    ours = tenc.init_params(cfg, seed=0, head=True)
    assert _paths(ours) == _paths(params)
    H = cfg.hidden
    d0 = ours["params"]["Dense_0"]["kernel"]
    assert d0.shape == (H, H) and abs(d0.std() - 1 / np.sqrt(H)) < 0.1 / np.sqrt(H)
    assert ours["params"]["Dense_1"]["kernel"].shape == (H, 1)
    assert (ours["params"]["Dense_1"]["bias"] == 0).all()
    # the trunk draws the same bits with and without the head
    plain = tenc.init_params(cfg, seed=0)
    np.testing.assert_array_equal(
        plain["params"]["Encoder_0"]["TransformerBlock_1"]["Dense_1"]["kernel"],
        ours["params"]["Encoder_0"]["TransformerBlock_1"]["Dense_1"]["kernel"],
    )


def test_packed_head_matches_jax_bitwise(jax_params, model_dir):
    cfg, params = jax_params
    ref = jenc.pack_fast_params(params, cfg)
    ours = tenc.pack_fast_params(params, tenc.config_for(model_dir))
    assert set(ours["head"]) == set(ref["head"]) == {"d0_k", "d0_b", "d1_k", "d1_b"}
    for key, value in ref["head"].items():
        assert ours["head"][key].dtype == torch.float32, key
        np.testing.assert_array_equal(ours["head"][key].numpy(), np.asarray(value), err_msg=key)
    for lt, lj in zip(ours["layers"], ref["layers"]):
        for key in lj:
            np.testing.assert_array_equal(_np(lt[key]), _np(lj[key]), err_msg=key)


def _ragged_batch(vocab, B=6, S=32, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(104, vocab, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 20:] = 0
    mask[2, 5:] = 0
    mask[4, 30:] = 0
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "pallas_interpret"])
def test_fused_cross_apply_matches_jax(jax_params, model_dir, interpret):
    cfg, params = jax_params
    tcfg = tenc.config_for(model_dir)
    ids, mask = _ragged_batch(cfg.vocab_size)
    ref = np.asarray(
        jenc.fused_cross_apply(
            jenc.pack_fast_params(params, cfg), jnp.asarray(ids), jnp.asarray(mask), cfg,
            interpret=interpret,
        ),
        np.float32,
    )
    with torch.inference_mode():
        out = tenc.fused_cross_apply(
            tenc.from_jax_params(params, tcfg, "cpu"), torch.from_numpy(ids), torch.from_numpy(mask), tcfg
        )
    assert out.dtype == torch.float32 and out.shape == ref.shape == (ids.shape[0],)
    out = out.numpy()
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() < score_tol(ref), (out, ref)


def test_score_matches_jax(encoders):
    jce, tce = encoders
    pairs = _pairs(24)
    ref = np.asarray(jce.score(pairs), np.float32)
    out = tce.score(pairs)
    assert out.shape == ref.shape == (len(pairs),) and out.dtype == np.float32
    assert np.abs(out - ref).max() < score_tol(ref), (out, ref)
    # a longer cap on the pair length changes nothing for short pairs
    np.testing.assert_allclose(tce.score(pairs[:3], max_length=64), out[:3], atol=1e-5)


def test_cross_encoder_surface(encoders, model_dir):
    jce, tce = encoders
    assert tce.n_params() == jce.n_params()
    assert tce.score([]).shape == (0,)
    before = tce.forward_batches
    assert tce.score([("q", "d")] * 3).shape == (3,)
    assert tce.forward_batches == before + 1
    assert isinstance(tce.model, tenc.FusedCrossEncoder)
    tree = tce.model.tree()
    assert set(tree["head"]) == {"d0_k", "d0_b", "d1_k", "d1_b"}
    # warm-up runs every batch bucket at each seq bucket, and counts no dispatch
    before = tce.forward_batches
    assert tce.warmup(seq_lens=(16, 32), buckets=(1, 2, 4)) == 6
    assert tce.warmup() == len(tce._executor._callables[tce._callable].policy.buckets())
    assert tce.forward_batches == before


def test_shared_cross_encoder_returns_one_instance(model_dir):
    with no_transformers():
        a = tenc.shared_cross_encoder(model_dir, device="cpu")
        b = tenc.shared_cross_encoder(model_dir, device="cpu")
        s = tenc.shared_sentence_encoder(model_dir, device="cpu")
    assert a is b
    assert isinstance(a, tenc.CrossEncoder) and isinstance(s, tenc.SentenceEncoder)
    assert s is tenc.shared_sentence_encoder(model_dir, device="cpu")
    tenc.shared_cross_encoder.cache_clear()
    tenc.shared_sentence_encoder.cache_clear()

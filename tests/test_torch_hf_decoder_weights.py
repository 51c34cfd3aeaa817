"""The port's decoder checkpoint mapping against the JAX package's
``load_hf_decoder_weights``, on tiny random ``transformers`` checkpoints
(a ``MistralForCausalLM`` and a ``MixtralForCausalLM``) saved in a
temporary directory.  Nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from pathway_tpu.models import decoder as jdec  # noqa: E402
from pathway_tpu_torch.models import decoder as tdec  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
SHAPE = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, intermediate_size=48, max_position_embeddings=64,
             rope_theta=1e6, sliding_window=None, tie_word_embeddings=False)


def _save(model, path):
    model.eval()
    model.save_pretrained(str(path))
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    torch.manual_seed(0)
    dense = transformers.MistralForCausalLM(transformers.MistralConfig(**SHAPE))
    torch.manual_seed(1)
    moe = transformers.MixtralForCausalLM(
        transformers.MixtralConfig(**SHAPE, num_local_experts=4, num_experts_per_tok=2))
    return {
        "dense": (_save(dense, tmp_path_factory.mktemp("tiny-mistral")), dense),
        "moe": (_save(moe, tmp_path_factory.mktemp("tiny-mixtral")), moe),
    }


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _cfgs(path, f32):
    jc, tc = jdec.decoder_config_for(path), tdec.decoder_config_for(path)
    if f32:
        jc = dataclasses.replace(jc, dtype=jax.numpy.float32)
        tc = dataclasses.replace(tc, dtype=torch.float32)
    return jc, tc


@pytest.mark.parametrize("kind", ["dense", "moe"])
@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_mapping_matches_the_jax_loader_leaf_for_leaf(ckpts, kind, f32):
    path = ckpts[kind][0]
    jc, tc = _cfgs(path, f32)
    assert tc.experts == (4 if kind == "moe" else 0)
    want = _leaves(jax.device_get(jdec.load_hf_decoder_weights(path, jc)))
    got = _leaves(tdec.load_hf_decoder_weights(path, tc, "cpu"))
    assert set(got) == set(want)
    for name, w in got.items():
        expect = np.asarray(want[name], np.float32)
        assert tuple(w.shape) == expect.shape, name
        assert w.dtype == (torch.float32 if name.endswith("moe_router") else tc.dtype), name
        np.testing.assert_array_equal(w.float().numpy(), expect, err_msg=name)


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_int8_mapping_equals_quantizing_the_jax_tree(ckpts, kind):
    """``quantize="int8"`` quantizes each matrix as it is moved: the codes
    of the JAX ``quantize_decoder_tree`` over the JAX loader's tree."""
    path = ckpts[kind][0]
    jc, tc = _cfgs(path, False)
    want = _leaves(jax.device_get(jdec.quantize_decoder_tree(jdec.load_hf_decoder_weights(path, jc))))
    got = _leaves(tdec.load_hf_decoder_weights(path, tc, "cpu", quantize="int8"))
    assert set(got) == set(want)
    for name, w in got.items():
        if name.endswith("/q"):
            np.testing.assert_array_equal(w.numpy(), np.asarray(want[name]), err_msg=name)
        else:
            np.testing.assert_allclose(w.float().numpy(), np.asarray(want[name], np.float32), rtol=1e-7, err_msg=name)


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_mapped_logits_match_the_transformers_model(ckpts, kind):
    """In f32 the port's prefill logits on the mapped tree are the
    checkpoint's own model's (``transformers``, f32) at every position of a
    prompt, at the decoder pin."""
    path, model = ckpts[kind]
    _, tc = _cfgs(path, True)
    tree = tdec.load_hf_decoder_weights(path, tc, "cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(1, SHAPE["vocab_size"], size=(2, 12)))
    with torch.no_grad():
        want = model(ids).logits
    for n in (5, 12):
        got = tdec.prefill(tree, ids[:, :n], torch.tensor([n, n]), tc, 16)[0]
        np.testing.assert_allclose(got.numpy(), want[:, n - 1].numpy(), **TOL)


def test_decoder_lm_loads_the_checkpoint(ckpts):
    path = ckpts["moe"][0]
    lm = tdec.DecoderLM(path, max_cache=32, device="cpu")
    assert lm.pretrained and lm.config.experts == 4
    ref = tdec.load_hf_decoder_weights(path, lm.config, "cpu")
    assert torch.equal(lm.params["layers"]["wg"], ref["layers"]["wg"])
    q = tdec.DecoderLM(path, max_cache=32, quantize="int8", device="cpu")
    assert q.pretrained and q.params["layers"]["wd"]["q"].dtype == torch.int8
    assert len(q.generate_ids([[3, 4, 5]], max_new_tokens=4)[0]) <= 4


def test_layout_mismatch_and_missing_checkpoints_give_none(ckpts, tmp_path, monkeypatch):
    dense_path = ckpts["dense"][0]
    moe_cfg = dataclasses.replace(tdec.decoder_config_for(dense_path), experts=4)
    assert tdec.load_hf_decoder_weights(dense_path, moe_cfg, "cpu") is None
    dense_cfg = dataclasses.replace(tdec.decoder_config_for(ckpts["moe"][0]), experts=0)
    assert tdec.load_hf_decoder_weights(ckpts["moe"][0], dense_cfg, "cpu") is None
    assert tdec.map_hf_decoder_state_dict({"unrelated": np.zeros(2)}, moe_cfg, "cpu") is None
    assert tdec.load_hf_decoder_weights(str(tmp_path), moe_cfg, "cpu") is None  # no weights there
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no-cache"))
    assert tdec.load_hf_decoder_weights("pw-tiny-decoder", moe_cfg, "cpu") is None
    monkeypatch.setitem(sys.modules, "transformers", None)  # as on a machine without it
    assert tdec.load_hf_decoder_weights(dense_path, moe_cfg, "cpu") is None
    lm = tdec.DecoderLM(dense_path, max_cache=32, device="cpu")
    assert not lm.pretrained

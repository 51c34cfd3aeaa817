"""The port's checkpoint mapping against the JAX package's
``load_hf_weights``, on tiny random ``transformers`` checkpoints saved in a
temporary directory (a BertModel and a one-label
BertForSequenceClassification, as ``tests/test_model_parity.py`` builds
them).  Nothing is downloaded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402

from pathway_tpu.models import encoder as jenc  # noqa: E402
from pathway_tpu_torch.models import encoder as tenc  # noqa: E402

VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "the", "cat", "sat", "on", "mat", "dog", "##s", "ran", "fast",
    "stream", "##ing", "data", "path", "##way", "hello", "world", ".", "!",
]
PAIRS = [
    ("the cat sat", "on the mat ."),
    ("hello world", "streaming data !"),
    ("dogs ran fast", "the cat"),
    ("pathway", "data streaming path"),
]


def _bert_config():
    return transformers.BertConfig(
        vocab_size=len(VOCAB),
        hidden_size=32,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=64,
        max_position_embeddings=64,
        type_vocab_size=2,
    )


def _save(model, path):
    model.eval()
    model.save_pretrained(str(path))
    (path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    transformers.BertTokenizer(str(path / "vocab.txt"), do_lower_case=True).save_pretrained(str(path))
    return str(path)


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    torch.manual_seed(0)
    return _save(transformers.BertModel(_bert_config()), tmp_path_factory.mktemp("tiny-bert"))


@pytest.fixture(scope="module")
def cross_dir(tmp_path_factory):
    cfg = _bert_config()
    cfg.num_labels = 1
    torch.manual_seed(1)
    return _save(transformers.BertForSequenceClassification(cfg), tmp_path_factory.mktemp("tiny-cross"))


def _jax_init(module_cls, cfg):
    params = module_cls(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32)
    )
    return jax.device_get(params)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("kind", ["sentence", "cross"])
def test_loader_gives_the_jax_tree(bert_dir, cross_dir, kind):
    path, module_cls = {
        "sentence": (bert_dir, jenc.SentenceEncoderModule),
        "cross": (cross_dir, jenc.CrossEncoderModule),
    }[kind]
    jcfg, tcfg = jenc.config_for(path), tenc.config_for(path)
    assert (tcfg.hidden, tcfg.layers, tcfg.max_len) == (32, 2, 64)
    params = _jax_init(module_cls, jcfg)
    ref = jenc.load_hf_weights(path, params, jcfg)
    ours = tenc.load_hf_weights(path, tenc._to_numpy(params), tcfg)
    assert ref is not None and ours is not None
    ref, ours = _leaves(jax.device_get(ref)), _leaves(ours)
    assert set(ours) == set(ref)
    for name, value in ref.items():
        assert ours[name].dtype == np.float32, name
        np.testing.assert_array_equal(ours[name], value, err_msg=name)
    if kind == "cross":  # the pooler and the classifier landed on the head
        hf = transformers.BertForSequenceClassification.from_pretrained(path)
        np.testing.assert_array_equal(ours["params/Dense_1/kernel"], hf.classifier.weight.detach().numpy().T)


def test_layer_count_mismatch_gives_none(bert_dir):
    tcfg = dataclasses.replace(tenc.config_for(bert_dir), layers=1)
    assert tenc.load_hf_weights(bert_dir, tenc.init_params(tcfg), tcfg) is None
    deeper = dataclasses.replace(tcfg, layers=3)
    assert tenc.load_hf_weights(bert_dir, tenc.init_params(deeper), deeper) is None


def test_no_weights_gives_none(tmp_path):
    _bert_config().save_pretrained(str(tmp_path))  # config.json only
    tcfg = tenc.config_for(str(tmp_path))
    assert tenc.load_hf_weights(str(tmp_path), tenc.init_params(tcfg), tcfg) is None
    params, pretrained = tenc.init_model_params(str(tmp_path), tcfg, seed=0)
    assert not pretrained and "Encoder_0" in params["params"]


def test_map_rejects_a_wrong_shape(bert_dir):
    tcfg = tenc.config_for(bert_dir)
    hf = transformers.BertModel.from_pretrained(bert_dir)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    params = tenc.init_params(tcfg)
    assert tenc.map_hf_state_dict(sd, params, tcfg) is not None
    sd["encoder.layer.1.output.dense.bias"] = np.zeros(5, np.float32)
    assert tenc.map_hf_state_dict(sd, params, tcfg) is None
    del sd["embeddings.LayerNorm.bias"]
    assert tenc.map_hf_state_dict(sd, params, tcfg) is None
    # the input tree is left as it was
    assert (params["params"]["Encoder_0"]["LayerNorm_0"]["bias"] == 0).all()


def test_cross_encoder_scores_track_transformers(cross_dir):
    """``CrossEncoder(checkpoint_dir).score``, through the HF tokenizer and
    the fused bf16 path, against BertForSequenceClassification logits
    (0.05, the JAX package's end-to-end pin); the f32 module forward is
    held to 1e-4."""
    hf = transformers.BertForSequenceClassification.from_pretrained(cross_dir)
    tok = transformers.AutoTokenizer.from_pretrained(cross_dir)
    enc = tok([p[0] for p in PAIRS], [p[1] for p in PAIRS], padding=True, return_tensors="pt")
    with torch.no_grad():  # every token of type 0, as the mapping folds it
        ref = hf(input_ids=enc["input_ids"], attention_mask=enc["attention_mask"]).logits[:, 0].numpy()
    ce = tenc.CrossEncoder(cross_dir, device="cpu")
    assert ce.pretrained
    assert np.abs(ce.score(PAIRS) - ref).max() < 0.05
    f32 = dataclasses.replace(ce.config, dtype=torch.float32)
    module = tenc.CrossEncoderModule(f32, ce.params)
    with torch.inference_mode():
        out = module(enc["input_ids"], enc["attention_mask"]).numpy()
    assert np.abs(out - ref).max() < 1e-4

"""Sentence encoder (SentenceTransformer-class) for the PyTorch port.

Counterpart of ``pathway_tpu/models/encoder.py``'s fused inference path,
the JAX package's default (``PATHWAY_FUSED_ENCODER``): the weights are
packed once into a flat bf16 tree (QKV kernels concatenated into one
``[H, 3H]`` operand) and the BERT trunk runs on 2D ``[B*S, H]``
activations, with attention in the hand-written CUDA kernel
(``ops/attention.py``).  The trunk's dense projections are plain
``torch.matmul``, as the JAX package left them to XLA.

Architectures mirror the reference's default checkpoints:
  * all-MiniLM-L6-v2 : 6 layers, hidden 384, 12 heads, ffn 1536, vocab 30522
  * bge-base-en-v1.5 : 12 layers, hidden 768, 12 heads, ffn 3072
Weights are a seeded random init with the Flax module's structure and
initialiser distributions (:func:`init_params`), or the JAX package's own
param tree carried across (:func:`from_jax_params`, ``set_params``).

The Flax module forward (exact-erf GELU, LayerNorm eps 1e-12), W8A8
matmuls, ``load_hf_weights`` and ``CrossEncoder`` wait for a later slice.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any

import numpy as np
import torch
from torch import nn

from pathway_tpu_torch.device import BucketPolicy, DeviceExecutor, resolve_device
from pathway_tpu_torch.models.tokenizer import (
    bucket_seq_len,
    load_tokenizer,
    pad_batch,
)
from pathway_tpu_torch.ops.attention import encoder_attention


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    intermediate: int = 1536
    max_len: int = 512
    dtype: Any = torch.bfloat16
    # sentence-embedding pooling: "mean" (MiniLM family) or "cls" (BGE family)
    pooling: str = "mean"


PRESETS: dict[str, EncoderConfig] = {
    "all-MiniLM-L6-v2": EncoderConfig(),
    "sentence-transformers/all-MiniLM-L6-v2": EncoderConfig(),
    "BAAI/bge-base-en-v1.5": EncoderConfig(
        hidden=768, layers=12, intermediate=3072, pooling="cls"
    ),
    "bge-base-en-v1.5": EncoderConfig(
        hidden=768, layers=12, intermediate=3072, pooling="cls"
    ),
    "BAAI/bge-small-en-v1.5": EncoderConfig(layers=12, pooling="cls"),
    "cross-encoder/ms-marco-MiniLM-L-6-v2": EncoderConfig(),
    "mixedbread-ai/mxbai-embed-large-v1": EncoderConfig(
        hidden=1024, layers=24, heads=16, intermediate=4096, pooling="cls"
    ),
}


def config_for(model_name: str) -> EncoderConfig:
    """Preset lookup, or — for a local checkpoint directory — the shape
    read from its ``config.json`` (any BERT-family ``transformers`` save),
    with the pooling mode taken from a sentence-transformers ``1_Pooling``
    module config when one is present."""
    if model_name in PRESETS:
        return PRESETS[model_name]
    cfg_path = os.path.join(model_name, "config.json")
    if os.path.isfile(cfg_path):
        with open(cfg_path) as f:
            hf = json.load(f)
        pooling = "mean"
        pool_path = os.path.join(model_name, "1_Pooling", "config.json")
        if os.path.isfile(pool_path):
            with open(pool_path) as f:
                pool_cfg = json.load(f)
            if pool_cfg.get("pooling_mode_cls_token"):
                pooling = "cls"
        return EncoderConfig(
            vocab_size=hf.get("vocab_size", 30522),
            hidden=hf.get("hidden_size", 384),
            layers=hf.get("num_hidden_layers", 6),
            heads=hf.get("num_attention_heads", 12),
            intermediate=hf.get("intermediate_size", 1536),
            max_len=hf.get("max_position_embeddings", 512),
            pooling=pooling,
        )
    return EncoderConfig()


# ---------------------------------------------------------------------------
# Parameters: the Flax module's tree, packed for the fused forward.
# ---------------------------------------------------------------------------


def init_params(config: EncoderConfig, seed: int = 0) -> dict:
    """Seeded random weights in the Flax ``SentenceEncoderModule`` tree
    structure (nested dicts of f32 numpy arrays), drawn from Flax's
    initialiser distributions: embeddings normal with std ``1/sqrt(H)``,
    dense kernels LeCun truncated normal (fan in), biases zero, LayerNorm
    scale one.  The bits differ from JAX's for the same seed."""
    gen = torch.Generator().manual_seed(seed)
    H, heads = config.hidden, config.heads
    hd = H // heads

    def normal(shape, std):
        return (torch.randn(shape, generator=gen) * std).numpy()

    def lecun(shape, fan_in):
        # Flax's truncated normal: cut at two standard deviations, then
        # rescaled so the variance is 1/fan_in; drawn by inverting the CDF
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        cdf_lo = (1.0 + math.erf(-math.sqrt(2.0))) / 2.0  # Φ(-2)
        u = cdf_lo + (1.0 - 2.0 * cdf_lo) * torch.rand(shape, generator=gen, dtype=torch.float64)
        t = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
        return (t * std).to(torch.float32).numpy()

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ln():
        return {"scale": np.ones((H,), np.float32), "bias": zeros(H)}

    def dense(n_in, n_out):
        return {"kernel": lecun((n_in, n_out), n_in), "bias": zeros(n_out)}

    enc = {
        "Embed_0": {"embedding": normal((config.vocab_size, H), 1.0 / math.sqrt(H))},
        "Embed_1": {"embedding": normal((config.max_len, H), 1.0 / math.sqrt(H))},
        "LayerNorm_0": ln(),
    }
    for i in range(config.layers):
        att = {
            n: {"kernel": lecun((H, heads, hd), H), "bias": zeros(heads, hd)}
            for n in ("query", "key", "value")
        }
        att["out"] = {"kernel": lecun((heads, hd, H), H), "bias": zeros(H)}
        enc[f"TransformerBlock_{i}"] = {
            "MultiHeadDotProductAttention_0": att,
            "LayerNorm_0": ln(),
            "Dense_0": dense(H, config.intermediate),
            "Dense_1": dense(config.intermediate, H),
            "LayerNorm_1": ln(),
        }
    return {"params": {"Encoder_0": enc}}


def pack_fast_params(params, config: EncoderConfig, device="cpu") -> dict:
    """Repack a Flax-structured param tree (nested dicts of arrays) into
    the flat bf16 tree the fused forward consumes, on ``device``.  The
    reshapes are those of the JAX package's ``pack_fast_params``; the bf16
    cast rounds to nearest even on both sides."""
    p = params["params"] if "params" in params else params
    enc = p["Encoder_0"] if "Encoder_0" in p else p
    H = config.hidden

    def bf(x):
        t = torch.tensor(np.asarray(x, np.float32))
        return t.to(device=device, dtype=torch.bfloat16)

    def cat(arrays, axis):
        return np.concatenate([np.asarray(a, np.float32) for a in arrays], axis=axis)

    layers = []
    for i in range(config.layers):
        blk = enc[f"TransformerBlock_{i}"]
        att = blk["MultiHeadDotProductAttention_0"]
        names = ("query", "key", "value")
        layers.append(
            dict(
                qkv_k=bf(cat([np.reshape(att[n]["kernel"], (H, H)) for n in names], 1)),
                qkv_b=bf(cat([np.reshape(att[n]["bias"], (H,)) for n in names], 0)),
                out_k=bf(np.reshape(att["out"]["kernel"], (H, H))),
                out_b=bf(att["out"]["bias"]),
                ln0_s=bf(blk["LayerNorm_0"]["scale"]),
                ln0_b=bf(blk["LayerNorm_0"]["bias"]),
                ff1_k=bf(blk["Dense_0"]["kernel"]),
                ff1_b=bf(blk["Dense_0"]["bias"]),
                ff2_k=bf(blk["Dense_1"]["kernel"]),
                ff2_b=bf(blk["Dense_1"]["bias"]),
                ln1_s=bf(blk["LayerNorm_1"]["scale"]),
                ln1_b=bf(blk["LayerNorm_1"]["bias"]),
            )
        )
    return dict(
        emb_word=bf(enc["Embed_0"]["embedding"]),
        emb_pos=bf(enc["Embed_1"]["embedding"]),
        eln_s=bf(enc["LayerNorm_0"]["scale"]),
        eln_b=bf(enc["LayerNorm_0"]["bias"]),
        layers=layers,
    )


def from_jax_params(params, config: EncoderConfig, device) -> dict:
    """The port's packed state from the JAX package's Flax param tree, given
    as nested dicts of numpy arrays (``jax.device_get`` output), so that
    both packages compute the same function."""

    def to_numpy(tree):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: to_numpy(v) for k, v in tree.items()}
        return np.asarray(tree, np.float32)

    return pack_fast_params(to_numpy(params), config, resolve_device(device))


# ---------------------------------------------------------------------------
# Fused forward.
# ---------------------------------------------------------------------------


def _ln(x, scale, bias, eps: float = 1e-6):
    """LayerNorm with f32 centred two-pass statistics and the JAX fused
    path's bf16 rounding points: the centred value is rounded to the input
    dtype before squaring, and the normalised value before scale and bias."""
    H = x.shape[-1]
    mean = x.float().sum(-1, keepdim=True) / H
    xc = x.float() - mean
    xcb = xc.to(x.dtype)
    var = (xcb * xcb).float().sum(-1, keepdim=True) / H
    y = (xc * torch.rsqrt(var + eps)).to(x.dtype)
    return y * scale + bias


def _pool(x, attention_mask, pooling: str):
    """Masked mean or CLS pooling of token reps ``[B, S, H]`` → f32 [B, H]."""
    if pooling == "cls":
        return x[:, 0, :].float()
    m = attention_mask[:, :, None].to(x.dtype)
    pooled = (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    return pooled.float()


def fused_trunk(tree, input_ids, attention_mask, config: EncoderConfig, *, attention=encoder_attention):
    """BERT trunk over the packed tree; returns token reps ``[B, S, H]``.

    ``attention`` is the encoder-attention function: the kernel's wrapper,
    or its plain version to hold the kernel path against."""
    B, S = input_ids.shape
    H = config.hidden
    x = tree["emb_word"][input_ids.long()] + tree["emb_pos"][:S][None, :, :]
    x = _ln(x, tree["eln_s"], tree["eln_b"]).reshape(B * S, H)
    bias = torch.where(attention_mask > 0, 0.0, -1e9).to(torch.float32)  # [B, S]
    for lp in tree["layers"]:
        qkv = x @ lp["qkv_k"] + lp["qkv_b"]  # [B*S, 3H]
        # column views with row stride 3H: the kernel reads them in place
        ctx = attention(
            qkv[:, :H].reshape(B, S, H),
            qkv[:, H : 2 * H].reshape(B, S, H),
            qkv[:, 2 * H :].reshape(B, S, H),
            bias,
            config.heads,
        ).reshape(B * S, H)
        x = _ln(x + ctx @ lp["out_k"] + lp["out_b"], lp["ln0_s"], lp["ln0_b"])
        h = nn.functional.gelu(x @ lp["ff1_k"] + lp["ff1_b"], approximate="tanh")
        x = _ln(x + h @ lp["ff2_k"] + lp["ff2_b"], lp["ln1_s"], lp["ln1_b"])
    return x.reshape(B, S, H)


def fused_sentence_apply(tree, input_ids, attention_mask, config: EncoderConfig, *, attention=encoder_attention):
    """Trunk + masked pooling + L2 normalisation → f32 sentence embeddings."""
    x = fused_trunk(tree, input_ids, attention_mask, config, attention=attention)
    pooled = _pool(x, attention_mask, config.pooling)
    return pooled / (torch.linalg.norm(pooled, dim=1, keepdim=True) + 1e-12)


class _Buffers(nn.Module):
    """A flat dict of tensors held as module buffers."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t)

    def as_dict(self) -> dict:
        return dict(self.named_buffers(recurse=False))


class FusedSentenceEncoder(nn.Module):
    """Holds the packed bf16 tree; ``forward(ids, mask)`` gives embeddings."""

    def __init__(self, tree: dict, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.embed = _Buffers({k: v for k, v in tree.items() if k != "layers"})
        self.layers = nn.ModuleList(_Buffers(lp) for lp in tree["layers"])

    def tree(self) -> dict:
        return dict(self.embed.as_dict(), layers=[lp.as_dict() for lp in self.layers])

    def forward(self, input_ids, attention_mask):
        return fused_sentence_apply(self.tree(), input_ids, attention_mask, self.config)


class SentenceEncoder:
    """Text → normalized embedding vectors, batched on the device.

    Runs on ``cuda:0`` unless ``device`` names another device; without a
    card and without ``device`` it raises."""

    def __init__(
        self,
        model_name: str = "all-MiniLM-L6-v2",
        seed: int = 0,
        max_batch: int = 512,
        device=None,
    ):
        self.device = resolve_device(device)
        self.config = config_for(model_name)
        self.model_name = model_name
        self.tokenizer = load_tokenizer(
            model_name, self.config.vocab_size, self.config.max_len
        )
        self.max_batch = max_batch
        self.params = init_params(self.config, seed)
        self.model = FusedSentenceEncoder(
            pack_fast_params(self.params, self.config, self.device), self.config
        )
        self._executor = DeviceExecutor(self.device)
        self._callable = self._executor.register(
            f"encoder:SentenceEncoder:{model_name}:b{max_batch}",
            self.model,
            policy=BucketPolicy(max_bucket=max_batch),
        )

    def set_params(self, params) -> None:
        """Replace the weights with a Flax-structured tree, such as the JAX
        package's ``SentenceEncoder.params`` after ``jax.device_get``."""
        self.params = params
        self.model = FusedSentenceEncoder(
            from_jax_params(params, self.config, self.device), self.config
        )
        self._executor.register(
            self._callable, self.model, policy=BucketPolicy(max_bucket=self.max_batch)
        )

    @property
    def forward_batches(self) -> int:
        """Fixed-shape forward passes run so far."""
        return self._executor.dispatches(self._callable)

    @property
    def dimensions(self) -> int:
        return self.config.hidden

    def _run_padded(self, id_lists: list[list[int]], max_length: int | None = None) -> np.ndarray:
        """Pad to the bucketed seq length and hand the ragged batch to the
        executor, which buckets and pads the batch axis and splits batches
        above ``max_batch``."""
        if not id_lists:
            return np.zeros((0,), dtype=np.float32)
        longest = max(len(x) for x in id_lists)
        seq = bucket_seq_len(min(longest, max_length or self.config.max_len))
        ids, mask = pad_batch(id_lists, seq)
        return self._executor.run_batch(self._callable, (ids, mask))

    def encode(self, texts: list[str], max_length: int | None = None) -> np.ndarray:
        id_lists = [self.tokenizer.encode(t or "") for t in texts]
        return self._run_padded(id_lists, max_length)

    def encode_one(self, text: str) -> np.ndarray:
        return self.encode([text])[0]

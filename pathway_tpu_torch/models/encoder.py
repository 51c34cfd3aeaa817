"""Transformer encoders for the PyTorch port: the bi-encoder
(SentenceTransformer-class) and the cross-encoder (reranker-class).

Counterpart of ``pathway_tpu/models/encoder.py``.  The serving path is the
fused one, the JAX package's default (``PATHWAY_FUSED_ENCODER``): the
weights are packed once into a flat bf16 tree (QKV kernels concatenated
into one ``[H, 3H]`` operand) and the BERT trunk runs on 2D ``[B*S, H]``
activations, with attention in the hand-written CUDA kernel
(``ops/attention.py``).  The trunk's dense projections are plain
``torch.matmul``, as the JAX package left them to XLA, or, for W8A8
serving (``quantize="int8"``, ``PATHWAY_ENCODER_QUANTIZE=int8``), int8 ×
int8 products through ``torch._int_mm`` (:func:`_qdot`, an XLA
composition in the JAX package).  ``PATHWAY_FUSED_ENCODER=0`` runs the
Flax module forward instead (:class:`SentenceEncoderModule`,
:class:`CrossEncoderModule`): exact-erf GELU, LayerNorm eps 1e-12 and
plain attention, over the Flax-structured param tree.  It is a parity
path for the host: with it, an encoder on a CUDA device raises.

Architectures mirror the reference's default checkpoints:
  * all-MiniLM-L6-v2 : 6 layers, hidden 384, 12 heads, ffn 1536, vocab 30522
  * bge-base-en-v1.5 : 12 layers, hidden 768, 12 heads, ffn 3072
  * ms-marco-MiniLM-L-6-v2 cross-encoder: MiniLM trunk + scalar head
Weights are a seeded random init with the Flax modules' structure and
initialiser distributions (:func:`init_params`), a locally cached
``transformers`` BERT-family checkpoint (:func:`load_hf_weights`), or the
JAX package's own param tree carried across (:func:`from_jax_params`,
``set_params``).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import logging
import math
import os
from typing import Any

import numpy as np
import torch
from torch import nn

from pathway_tpu_torch.device import BucketPolicy, get_default_executor, resolve_device
from pathway_tpu_torch.models.tokenizer import (
    bucket_seq_len,
    load_tokenizer,
    pad_batch,
)
from pathway_tpu_torch.ops.attention import encoder_attention

_log = logging.getLogger(__name__)


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


def init_params(config: EncoderConfig, seed: int = 0, *, head: bool = False) -> dict:
    """Seeded random weights in the Flax ``SentenceEncoderModule`` tree
    structure (nested dicts of f32 numpy arrays), or with ``head`` the
    ``CrossEncoderModule`` one (the trunk under ``Encoder_0``, and the
    scoring head's ``Dense_0`` (H→H) and ``Dense_1`` (H→1) at the root),
    drawn from Flax's initialiser distributions: embeddings normal with std
    ``1/sqrt(H)``, dense kernels LeCun truncated normal (fan in), biases
    zero, LayerNorm scale one.  The bits differ from JAX's for the same
    seed; the trunk's are the same with and without the head."""
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
    root = {"Encoder_0": enc}
    if head:
        root["Dense_0"] = dense(H, H)
        root["Dense_1"] = dense(H, 1)
    return {"params": root}


def pack_fast_params(params, config: EncoderConfig, device="cpu") -> dict:
    """Repack a Flax-structured param tree (nested dicts of arrays) into
    the flat bf16 tree the fused forward consumes, on ``device``.  The
    reshapes are those of the JAX package's ``pack_fast_params``; the bf16
    cast rounds to nearest even on both sides.  A ``CrossEncoderModule``
    tree adds the scoring head, kept in f32."""
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
    tree = dict(
        emb_word=bf(enc["Embed_0"]["embedding"]),
        emb_pos=bf(enc["Embed_1"]["embedding"]),
        eln_s=bf(enc["LayerNorm_0"]["scale"]),
        eln_b=bf(enc["LayerNorm_0"]["bias"]),
        layers=layers,
    )
    if "Dense_0" in p:  # cross-encoder scoring head (kept in f32, tiny)

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        tree["head"] = dict(
            d0_k=f32(p["Dense_0"]["kernel"]),
            d0_b=f32(p["Dense_0"]["bias"]),
            d1_k=f32(p["Dense_1"]["kernel"]),
            d1_b=f32(p["Dense_1"]["bias"]),
        )
    return tree


def _to_numpy(tree):
    """A param tree (nested mappings of arrays) as nested dicts of f32 numpy."""
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def from_jax_params(params, config: EncoderConfig, device) -> dict:
    """The port's packed state from the JAX package's Flax param tree, given
    as nested dicts of numpy arrays (``jax.device_get`` output), so that
    both packages compute the same function."""
    return pack_fast_params(_to_numpy(params), config, resolve_device(device))


def quantize_encoder_tree(tree: dict) -> dict:
    """W8A8 serving tree: the four big matmul weights per layer become
    ``{"q": int8, "s": f32 per-output-channel}``; biases, layernorms,
    embeddings and the head stay as they are.

    Per output channel (the max over axis -2), symmetric: the scale is
    max|w| / 127 floored at 1e-12, the code ``round(w / s)`` (half to
    even, as ``jnp.round``) clipped to ±127, so the codes are the JAX
    package's.  ``q`` is a ``[K, N]`` view of an ``[N, K]`` contiguous
    tensor: the column-major second operand that ``torch._int_mm`` takes
    on CUDA."""

    def quant(w):
        w32 = w.float()
        s = torch.clamp(w32.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-12)
        q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
        return {"q": q.t().contiguous().t(), "s": s}

    layers = [
        {
            **lp,
            "qkv_k": quant(lp["qkv_k"]),
            "out_k": quant(lp["out_k"]),
            "ff1_k": quant(lp["ff1_k"]),
            "ff2_k": quant(lp["ff2_k"]),
        }
        for lp in tree["layers"]
    ]
    return {**tree, "layers": layers}


# ---------------------------------------------------------------------------
# Fused forward.
# ---------------------------------------------------------------------------


# torch._int_mm on CUDA takes more than 16 rows; fewer are padded with zero
# rows up to this count, and the padding is sliced off the product
_INT_MM_MIN_ROWS = 17


def _qdot(x, w):
    """``x @ w`` for 2D ``x``, where ``w`` may be a W8A8 pair: activations
    quantize per token (dynamic symmetric: the scale is the row's max|x|,
    taken in x's dtype and cast to f32, over 127, floored at 1e-8), the
    product runs int8 × int8 → int32 (``torch._int_mm``), and the two
    scales multiply the f32 sum before the cast back to x's dtype, as the
    JAX ``_qdot`` does.  A float ``w`` is the plain product."""
    if not isinstance(w, dict):
        return x @ w
    s_x = torch.clamp(x.abs().amax(dim=-1, keepdim=True).float() / 127.0, min=1e-8)
    xq = torch.clamp(torch.round(x.float() / s_x), -127, 127).to(torch.int8)
    rows = xq.shape[0]
    if rows < _INT_MM_MIN_ROWS:
        xq = nn.functional.pad(xq, (0, 0, 0, _INT_MM_MIN_ROWS - rows))
    acc = torch._int_mm(xq, w["q"])[:rows]
    return (acc.float() * s_x * w["s"]).to(x.dtype)


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
        qkv = _qdot(x, lp["qkv_k"]) + lp["qkv_b"]  # [B*S, 3H]
        # column views with row stride 3H: the kernel reads them in place
        ctx = attention(
            qkv[:, :H].reshape(B, S, H),
            qkv[:, H : 2 * H].reshape(B, S, H),
            qkv[:, 2 * H :].reshape(B, S, H),
            bias,
            config.heads,
        ).reshape(B * S, H)
        x = _ln(x + _qdot(ctx, lp["out_k"]) + lp["out_b"], lp["ln0_s"], lp["ln0_b"])
        h = nn.functional.gelu(_qdot(x, lp["ff1_k"]) + lp["ff1_b"], approximate="tanh")
        x = _ln(x + _qdot(h, lp["ff2_k"]) + lp["ff2_b"], lp["ln1_s"], lp["ln1_b"])
    return x.reshape(B, S, H)


def fused_sentence_apply(tree, input_ids, attention_mask, config: EncoderConfig, *, attention=encoder_attention):
    """Trunk + masked pooling + L2 normalisation → f32 sentence embeddings."""
    x = fused_trunk(tree, input_ids, attention_mask, config, attention=attention)
    pooled = _pool(x, attention_mask, config.pooling)
    return pooled / (torch.linalg.norm(pooled, dim=1, keepdim=True) + 1e-12)




def fused_cross_apply(tree, input_ids, attention_mask, config: EncoderConfig, *, attention=encoder_attention):
    """Trunk + CLS head → one f32 relevance score per (query, doc) pair: the
    CLS row in f32, the first dense, ``tanh``, the second dense."""
    x = fused_trunk(tree, input_ids, attention_mask, config, attention=attention)
    head = tree["head"]
    cls = x[:, 0, :].float()
    h = torch.tanh(cls @ head["d0_k"] + head["d0_b"])
    return (h @ head["d1_k"] + head["d1_b"])[:, 0]


class _Tree(nn.Module):
    """A tree of tensors (nested dicts) held as buffers under its own names,
    a child module per nested dict.  Leaves that are not tensors yet (numpy
    arrays) become f32 tensors on ``device``; ``modules`` puts a given
    module in place of a subtree."""

    def __init__(self, tree: dict, device=None, **modules):
        super().__init__()
        for name, value in tree.items():
            if name in modules:
                self.add_module(name, modules[name])
            elif hasattr(value, "items"):
                self.add_module(name, _Tree(value, device))
            elif isinstance(value, torch.Tensor):
                self.register_buffer(name, value)
            else:
                self.register_buffer(name, torch.tensor(np.asarray(value, np.float32), device=device))

    def as_dict(self) -> dict:
        out = dict(self.named_buffers(recurse=False))
        for name, child in self.named_children():
            out[name] = child.as_dict()
        return out


class FusedSentenceEncoder(nn.Module):
    """Holds the packed tree; ``forward(ids, mask)`` gives embeddings."""

    def __init__(self, tree: dict, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.embed = _Tree({k: v for k, v in tree.items() if k not in ("layers", "head")})
        self.layers = nn.ModuleList(_Tree(lp) for lp in tree["layers"])
        if "head" in tree:
            self.head = _Tree(tree["head"])

    def tree(self) -> dict:
        out = dict(self.embed.as_dict(), layers=[lp.as_dict() for lp in self.layers])
        if hasattr(self, "head"):
            out["head"] = self.head.as_dict()
        return out

    def forward(self, input_ids, attention_mask):
        return fused_sentence_apply(self.tree(), input_ids, attention_mask, self.config)


class FusedCrossEncoder(FusedSentenceEncoder):
    """Holds the packed tree with its scoring head; ``forward(ids, mask)``
    gives one score per pair."""

    def forward(self, input_ids, attention_mask):
        return fused_cross_apply(self.tree(), input_ids, attention_mask, self.config)


# ---------------------------------------------------------------------------
# The Flax module forward (``PATHWAY_FUSED_ENCODER=0``): nn.Modules that hold
# the Flax-structured tree under its Flax names and compute what Flax's
# ``module.apply`` computes, in ``config.dtype``.
# ---------------------------------------------------------------------------


def _layer_norm(x, p, dtype, eps: float = 1e-12):
    """Flax ``nn.LayerNorm``: f32 statistics with the variance as
    E[x²] − E[x]² floored at 0, scale and bias applied in f32, then the
    cast to ``dtype``."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (x32 - mu) * (torch.rsqrt(var + eps) * p.scale) + p.bias
    return y.to(dtype)


def _dense(x, kernel, bias, dtype):
    """Flax ``nn.Dense``: input, kernel and bias promoted to ``dtype``."""
    return x.to(dtype) @ kernel.to(dtype) + bias.to(dtype)


class TransformerBlock(_Tree):
    """Post-LN BERT block: Flax ``MultiHeadDotProductAttention`` (projections
    in ``config.dtype``, the query scaled by 1/sqrt(hd) in that dtype, the
    boolean key mask filled with the dtype's minimum, softmax in that
    dtype), then the exact-erf GELU feed-forward, LayerNorm eps 1e-12."""

    def __init__(self, config: EncoderConfig, tree: dict, device=None):
        super().__init__(tree, device)
        self.config = config

    def forward(self, x, mask):
        cfg, dt = self.config, self.config.dtype
        B, S, H = x.shape
        heads = cfg.heads
        hd = H // heads
        att = self.MultiHeadDotProductAttention_0

        def project(p):
            return _dense(x, p.kernel.reshape(H, H), p.bias.reshape(H), dt).reshape(B, S, heads, hd)

        q = project(att.query) / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dt)
        k, v = project(att.key), project(att.value)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = torch.where(mask, w, torch.finfo(dt).min)
        w = torch.softmax(w, dim=-1).to(dt)
        ctx = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, S, H)
        attn_out = _dense(ctx, att.out.kernel.reshape(H, H), att.out.bias, dt)
        x = _layer_norm(x + attn_out, self.LayerNorm_0, dt)
        h = nn.functional.gelu(_dense(x, self.Dense_0.kernel, self.Dense_0.bias, dt), approximate="none")
        h = _dense(h, self.Dense_1.kernel, self.Dense_1.bias, dt)
        return _layer_norm(x + h, self.LayerNorm_1, dt)


class Encoder(_Tree):
    """BERT-style trunk producing token representations ``[B, S, H]``."""

    def __init__(self, config: EncoderConfig, tree: dict, device=None):
        blocks = {
            f"TransformerBlock_{i}": TransformerBlock(config, tree[f"TransformerBlock_{i}"], device)
            for i in range(config.layers)
        }
        super().__init__(tree, device, **blocks)
        self.config = config

    def forward(self, input_ids, attention_mask):
        cfg, dt = self.config, self.config.dtype
        S = input_ids.shape[1]
        # F.embedding, not indexing: the same gather forward, and a backward
        # that reduces repeated ids (padding) in parallel where the indexing
        # backward walks them one by one
        tok = nn.functional.embedding(input_ids.long(), self.Embed_0.embedding.to(dt))
        pos = self.Embed_1.embedding.to(dt)[:S][None, :, :]
        x = _layer_norm(tok + pos, self.LayerNorm_0, dt)
        mask = attention_mask[:, None, None, :].bool()  # [B, 1, 1, S]: keys
        for i in range(cfg.layers):
            x = getattr(self, f"TransformerBlock_{i}")(x, mask)
        return x


class SentenceEncoderModule(_Tree):
    """Trunk + masked pooling + L2 normalisation → f32 sentence embedding,
    over a ``SentenceEncoderModule`` param tree."""

    def __init__(self, config: EncoderConfig, params: dict, device=None):
        p = params["params"]
        super().__init__(p, device, Encoder_0=Encoder(config, p["Encoder_0"], device))
        self.config = config

    def forward(self, input_ids, attention_mask):
        x = self.Encoder_0(input_ids, attention_mask)
        pooled = _pool(x, attention_mask, self.config.pooling)
        return pooled / (torch.linalg.norm(pooled, dim=1, keepdim=True) + 1e-12)


class CrossEncoderModule(SentenceEncoderModule):
    """Trunk + CLS head → f32 relevance score per (query, doc) pair, over a
    ``CrossEncoderModule`` param tree; the head's denses run in f32."""

    def forward(self, input_ids, attention_mask):
        x = self.Encoder_0(input_ids, attention_mask)
        cls = x[:, 0, :].float()
        h = torch.tanh(_dense(cls, self.Dense_0.kernel, self.Dense_0.bias, torch.float32))
        return _dense(h, self.Dense_1.kernel, self.Dense_1.bias, torch.float32)[:, 0]


# ---------------------------------------------------------------------------
# Checkpoints: a ``transformers`` BERT-family state dict onto the Flax tree.
# ---------------------------------------------------------------------------


def map_hf_state_dict(state_dict: dict, params: dict, config: EncoderConfig) -> dict | None:
    """A BERT-family ``state_dict`` (names → numpy arrays) mapped onto a copy
    of the Flax-structured ``params``; ``None`` when it does not fit.

    The rules of the JAX ``load_hf_weights``: token-type embedding 0 is
    folded into the word table (every token is of type 0 here); the
    checkpoint's layer count must equal the config's (mapping a prefix of a
    deeper trunk would truncate the model); a tree with a scoring head
    takes ``pooler.dense`` and ``classifier`` as its two denses.  A missing
    name or a shape that differs from the tree's gives ``None``."""
    root = params["params"]
    has_head = "Dense_0" in root and "Encoder_0" in root
    # *ForSequenceClassification prefixes the trunk with the model type
    sd = {(k[5:] if k.startswith("bert.") else k): v for k, v in state_dict.items()}
    ckpt_layers = 1 + max(
        (int(k.split("layer.")[1].split(".")[0]) for k in sd if "layer." in k),
        default=-1,
    )
    if ckpt_layers != config.layers:
        return None
    h, heads = config.hidden, config.heads
    hd = h // heads
    new_params = copy.deepcopy(params)

    def put(path, value):
        cur = new_params["params"]
        for part in path[:-1]:
            cur = cur[part]
        expect = np.shape(cur[path[-1]])
        if tuple(value.shape) != tuple(expect):
            raise ValueError(f"{path}: shape {value.shape} != {expect}")
        cur[path[-1]] = np.asarray(value, np.float32)

    try:
        enc = ["Encoder_0"] if "Encoder_0" in root else []
        word = sd["embeddings.word_embeddings.weight"]
        type0 = sd["embeddings.token_type_embeddings.weight"][0]
        put(enc + ["Embed_0", "embedding"], word + type0[None, :])
        put(enc + ["Embed_1", "embedding"], sd["embeddings.position_embeddings.weight"][: config.max_len])
        put(enc + ["LayerNorm_0", "scale"], sd["embeddings.LayerNorm.weight"])
        put(enc + ["LayerNorm_0", "bias"], sd["embeddings.LayerNorm.bias"])
        for i in range(config.layers):
            blk = enc + [f"TransformerBlock_{i}"]
            lp = f"encoder.layer.{i}."
            attn = blk + ["MultiHeadDotProductAttention_0"]
            for name in ("query", "key", "value"):
                w = sd[f"{lp}attention.self.{name}.weight"]
                b = sd[f"{lp}attention.self.{name}.bias"]
                put(attn + [name, "kernel"], w.T.reshape(h, heads, hd))
                put(attn + [name, "bias"], b.reshape(heads, hd))
            wo = sd[f"{lp}attention.output.dense.weight"]
            put(attn + ["out", "kernel"], wo.T.reshape(heads, hd, h))
            put(attn + ["out", "bias"], sd[f"{lp}attention.output.dense.bias"])
            put(blk + ["LayerNorm_0", "scale"], sd[f"{lp}attention.output.LayerNorm.weight"])
            put(blk + ["LayerNorm_0", "bias"], sd[f"{lp}attention.output.LayerNorm.bias"])
            put(blk + ["Dense_0", "kernel"], sd[f"{lp}intermediate.dense.weight"].T)
            put(blk + ["Dense_0", "bias"], sd[f"{lp}intermediate.dense.bias"])
            put(blk + ["Dense_1", "kernel"], sd[f"{lp}output.dense.weight"].T)
            put(blk + ["Dense_1", "bias"], sd[f"{lp}output.dense.bias"])
            put(blk + ["LayerNorm_1", "scale"], sd[f"{lp}output.LayerNorm.weight"])
            put(blk + ["LayerNorm_1", "bias"], sd[f"{lp}output.LayerNorm.bias"])
        if has_head and "classifier.weight" in sd:
            put(["Dense_0", "kernel"], sd["pooler.dense.weight"].T)
            put(["Dense_0", "bias"], sd["pooler.dense.bias"])
            put(["Dense_1", "kernel"], sd["classifier.weight"].T)
            put(["Dense_1", "bias"], sd["classifier.bias"])
    except (KeyError, ValueError):
        return None
    return new_params


def load_hf_weights(model_name: str, params: dict, config: EncoderConfig) -> dict | None:
    """A locally cached ``transformers`` BERT-family checkpoint mapped onto
    ``params`` (:func:`map_hf_state_dict`), or ``None`` when there is none:
    no local directory or model cache, no ``transformers`` (the import is
    made here, never when the module is imported), or a load that fails.
    Nothing is downloaded.  A tree with a scoring head loads through
    ``AutoModelForSequenceClassification``, so that the pooler and the
    classifier map onto the head."""
    cache = os.path.expanduser(os.environ.get("HF_HOME", "~/.cache/huggingface"))
    if not os.path.isdir(model_name) and not os.path.isdir(cache):
        return None  # no local checkpoint can exist: skip the import
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    has_head = "Dense_0" in params["params"]
    try:
        if has_head:
            from transformers import AutoModelForSequenceClassification as auto
        else:
            from transformers import AutoModel as auto
        hf = auto.from_pretrained(model_name, local_files_only=True)
    except Exception:  # noqa: BLE001 -- any failure to load means "no checkpoint"
        _log.debug("no local checkpoint for %s", model_name, exc_info=True)
        return None
    sd = {k: v.detach().cpu().numpy() for k, v in hf.state_dict().items()}
    return map_hf_state_dict(sd, params, config)


def init_model_params(model_name: str, config: EncoderConfig, seed: int = 0, *, head: bool = False):
    """Seeded init, then a local checkpoint if there is one: returns
    ``(params, pretrained)``."""
    params = init_params(config, seed, head=head)
    loaded = load_hf_weights(model_name, params, config)
    if loaded is not None:
        return loaded, True
    return params, False


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

_FALSY = ("0", "false", "no", "off")


def _forward(model, input_ids, attention_mask):
    """The registered device callable: the model (its weights) is the
    operand of every dispatch, not a closure, so instances of one model
    share one registration and each runs its own weights."""
    return model(input_ids, attention_mask)


class _EncoderModel:
    """What the sentence encoder and the cross-encoder share: config,
    tokenizer, params, the model on the device and its registration on
    the device's default executor, ``set_params``, ``n_params``,
    ``warmup`` and ``_run_padded``.

    ``PATHWAY_FUSED_ENCODER`` (on by default) selects the fused path, and
    ``0`` the Flax module forward, which runs on the host only: its
    attention is the plain one, not the card's kernel, so with it a CUDA
    device raises ``ValueError``.  ``quantize="int8"`` switches the fused
    path to W8A8 matmuls; ``PATHWAY_ENCODER_QUANTIZE=int8`` sets that
    default for sentence encoders only (a cross-encoder quantizes only when
    asked per instance, as its score fidelity is not pinned).  Runs on
    ``cuda:0`` unless ``device`` names another device; without a card and
    without ``device`` it raises.

    ``host_fallback`` serves the batches the executor's breaker routes
    away from the device (``DeviceExecutor.register``); there is none
    unless one is passed, such as :meth:`as_host_fallback` of an encoder
    of the same model and seed on ``device="cpu"``."""

    _head = False  # the cross-encoder's scoring head

    def __init__(
        self,
        model_name: str,
        seed: int = 0,
        max_batch: int = 512,
        quantize: str | None = None,
        device=None,
        host_fallback=None,
    ):
        env_q = None if self._head else os.environ.get("PATHWAY_ENCODER_QUANTIZE")
        self._quantize = quantize or env_q or None
        if self._quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {self._quantize!r}")
        # on unless set to a false value, as the JAX package reads it
        self._fused = os.environ.get("PATHWAY_FUSED_ENCODER", "").strip().lower() not in _FALSY
        if self._quantize and not self._fused:
            raise ValueError("quantize='int8' requires the fused encoder path")
        if not self._fused and (device is None or torch.device(device).type == "cuda"):
            raise ValueError(
                "PATHWAY_FUSED_ENCODER=0 selects the module forward, which runs on the "
                "host only; pass device='cpu' or leave the fused path on"
            )
        self.device = resolve_device(device)
        self.config = config_for(model_name)
        self.model_name = model_name
        self.tokenizer = load_tokenizer(model_name, self.config.vocab_size, self.config.max_len)
        self.max_batch = max_batch
        params, self.pretrained = init_model_params(model_name, self.config, seed, head=self._head)
        self.set_params(params)
        # keyed by everything the callable's behaviour depends on but the
        # weights: a re-created instance replaces the registration instead
        # of growing the shared executor; a fallback is per instance
        name = (
            f"encoder:{type(self).__name__}:{model_name}:b{max_batch}"
            f":f{int(self._fused)}:q{self._quantize or '-'}"
        )
        if host_fallback is not None:
            name += f":h{id(host_fallback):x}"
        self._executor = get_default_executor(self.device)
        self._callable = self._executor.register(
            name, _forward, policy=BucketPolicy(max_bucket=self.max_batch), host_fallback=host_fallback
        )

    def set_params(self, params) -> None:
        """Replace the weights with a Flax-structured tree, such as the JAX
        package's ``params`` after ``jax.device_get``."""
        self.params = _to_numpy(params)
        if self._fused:
            tree = pack_fast_params(self.params, self.config, self.device)
            if self._quantize == "int8":
                tree = quantize_encoder_tree(tree)
            fused = FusedCrossEncoder if self._head else FusedSentenceEncoder
            self.model = fused(tree, self.config)
        else:
            module = CrossEncoderModule if self._head else SentenceEncoderModule
            self.model = module(self.config, self.params, self.device)

    def as_host_fallback(self):
        """A ``host_fallback`` for an encoder of the same model on another
        device: runs this instance's model (e.g. on ``device="cpu"``) on
        the padded rows and ignores the card's weights it is handed."""

        def fallback(_model, input_ids, attention_mask):
            return self.model(input_ids.to(self.device), attention_mask.to(self.device))

        return fallback

    def n_params(self) -> int:
        def count(tree):
            return sum(count(v) if hasattr(v, "items") else int(np.size(v)) for v in tree.values())

        return count(self.params)

    @property
    def forward_batches(self) -> int:
        """Fixed-shape forward passes of this model's registration so far
        (warm-up not counted)."""
        return self._executor.dispatches(self._callable)

    def warmup(self, *, seq_lens: tuple[int, ...] = (), buckets=None) -> int:
        """Run every (batch bucket × seq bucket) once before traffic, on
        all-padding rows; returns how many shapes it ran."""
        seq_lens = seq_lens or (bucket_seq_len(self.config.max_len),)
        return sum(
            self._executor.warmup(
                self._callable,
                row_shapes=((seq,), (seq,)),
                dtypes=(np.int32, np.int32),
                operands=(self.model,),
                buckets=buckets,
            )
            for seq in seq_lens
        )

    def _run_padded(self, id_lists: list[list[int]], max_length: int | None = None) -> np.ndarray:
        """Pad to the bucketed seq length and hand the ragged batch to the
        executor, which buckets and pads the batch axis and splits batches
        above ``max_batch``."""
        if not id_lists:
            return np.zeros((0,), dtype=np.float32)
        longest = max(len(x) for x in id_lists)
        seq = bucket_seq_len(min(longest, max_length or self.config.max_len))
        ids, mask = pad_batch(id_lists, seq)
        return self._executor.run_batch(self._callable, (ids, mask), operands=(self.model,))


class SentenceEncoder(_EncoderModel):
    """Text → normalized embedding vectors, batched on the device."""

    def __init__(
        self,
        model_name: str = "all-MiniLM-L6-v2",
        seed: int = 0,
        max_batch: int = 512,
        quantize: str | None = None,
        device=None,
        host_fallback=None,
    ):
        super().__init__(model_name, seed, max_batch, quantize, device, host_fallback)

    @property
    def dimensions(self) -> int:
        return self.config.hidden

    def encode(self, texts: list[str], max_length: int | None = None) -> np.ndarray:
        id_lists = [self.tokenizer.encode(t or "") for t in texts]
        return self._run_padded(id_lists, max_length)

    def encode_one(self, text: str) -> np.ndarray:
        return self.encode([text])[0]


class CrossEncoder(_EncoderModel):
    """(query, doc) pairs → relevance scores, batched on the device."""

    _head = True

    def __init__(
        self,
        model_name: str = "cross-encoder/ms-marco-MiniLM-L-6-v2",
        seed: int = 0,
        max_batch: int = 512,
        quantize: str | None = None,
        device=None,
        host_fallback=None,
    ):
        super().__init__(model_name, seed, max_batch, quantize, device, host_fallback)

    def score(self, pairs: list[tuple[str, str]], max_length: int | None = None) -> np.ndarray:
        """One f32 score per pair, from ``[CLS] query [SEP] doc [SEP]``."""
        id_lists = [self.tokenizer.encode_pair(q or "", d or "") for (q, d) in pairs]
        return self._run_padded(id_lists, max_length)


@functools.lru_cache(maxsize=8)
def shared_sentence_encoder(model_name: str = "all-MiniLM-L6-v2", device=None) -> SentenceEncoder:
    """One ``SentenceEncoder`` per (model, device) in the process."""
    return SentenceEncoder(model_name, device=device)


@functools.lru_cache(maxsize=8)
def shared_cross_encoder(model_name: str = "cross-encoder/ms-marco-MiniLM-L-6-v2", device=None) -> CrossEncoder:
    """One ``CrossEncoder`` per (model, device) in the process."""
    return CrossEncoder(model_name, device=device)

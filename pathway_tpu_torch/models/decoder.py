"""Decoder-only LLM (Mistral/LLaMA-class) for the PyTorch port.

Counterpart of ``pathway_tpu/models/decoder.py``: the same param tree
(layer weights stacked along a leading ``[layers, ...]`` axis), the same
forward (RMSNorm, rotary embeddings, grouped-query attention with f32
scores, SwiGLU MLP) and the same two serving shapes:

  * **dense** — :func:`prefill` over a bucketed prompt fills a
    ``[layers, B, cache, KH, D]`` cache, :func:`decode_step` adds one
    token per row; :class:`DecoderLM` runs them (``generate_ids``).
  * **paged** — :func:`paged_prefill_chunk` and :func:`paged_decode_step`
    read and write fixed-size pages of a ``[layers, pages, page, KH, D]``
    pool through per-slot block tables; the continuous-batching scheduler
    (``serving/generation.py``) drives them.

Mixtral-style sparse MoE layers (``cfg.experts > 0``) run the GShard
dispatch of ``parallel/moe.py``; weight-only int8 trees
(:func:`quantize_decoder_tree`, ``DecoderLM(quantize="int8")``) keep every
matmul weight as int8 codes with per-output-channel f32 scales; and
:func:`speculative_decode_chunk` drafts with the int8 tree and verifies with
the float one (:func:`verify_block`).

The JAX package computes all of it as XLA compositions (there is no
Pallas kernel on this path), and the port runs it as plain PyTorch ops.
Functions are eager: caches and pools are updated in place and returned.
Weights are a local ``transformers`` checkpoint when there is one
(:func:`load_hf_decoder_weights`), else a seeded random init made on the
target device (:func:`init_decoder_params`), or the JAX package's tree
carried across (:func:`from_jax_decoder_params`).

LoRA-adapted trees (``models/lora.py``) run through every path unchanged:
:func:`_mm` takes their ``{"w", "a", "b"}`` leaves.

Training: :func:`causal_lm_logits_and_aux` is the next-token training
forward (all positions, no K/V cache, the MoE aux loss summed over the
layers, capacity dropping as in the JAX package); ``DecoderConfig.remat``
recomputes each layer in the backward pass.  ``parallel/train.py`` and
``make_lora_train_step`` (``models/lora.py``) drive it.

Tensor parallelism: :func:`tp_param_specs` and :func:`tp_cache_specs` are
the JAX package's Megatron layout (heads and FFN width split over a
``model`` mesh axis; an MoE config splits its experts instead), and
:func:`place_tp_params` places a tree by it.  :func:`prefill`,
:func:`decode_step` and :func:`causal_lm_logits_and_aux` take a placed
tree: each rank runs the layer on its local shards (:class:`ShardConfig`:
its heads, kv heads, FFN columns or experts) and the ranks' results are
joined by hand, the Megatron way: an all-reduce of the partial sums after
``wo`` and after ``wd`` (or the experts' combine), an all-gather of the
vocab-sharded logits, and their gradients (``parallel/collectives.py``).
The paged path has no tensor-parallel form: a placed tree raises there.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import math
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.models.tokenizer import load_tokenizer
from pathway_tpu_torch.ops import attention as attention_ops
from pathway_tpu_torch.ops.attention import gqa_attention as _attend
from pathway_tpu_torch.parallel.collectives import copy_to, gather_from, reduce_from
from pathway_tpu_torch.parallel.moe import ExpertShard, MoEConfig, moe_ffn
from pathway_tpu_torch.parallel.sharding import place_tree, spec_placements

_log = logging.getLogger(__name__)


def _bucket_prompt_len(n: int, cap: int) -> int:
    """Power-of-two prefill bucket, clamped to the cache capacity."""
    b = 16
    while b < n and b < cap:
        b <<= 1
    return min(b, cap)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8
    intermediate: int = 14336
    max_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # experts > 0 switches the MLP to Mixtral-style sparse MoE: per-layer
    # f32 router + stacked expert SwiGLU weights (parallel/moe.py)
    experts: int = 0
    experts_top_k: int = 2
    expert_capacity_factor: float = 2.0
    # Mistral-v0.1-style sliding-window attention: each query attends to
    # at most the last `sliding_window` positions (None = full causal)
    sliding_window: int | None = None
    # recompute each layer in the backward pass (torch.utils.checkpoint
    # around the layer, under grad only): activation memory drops from
    # O(layers) to O(1) layers at ~1/3 extra FLOPs
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    # A rank's share of a tensor-parallel layer (ShardConfig) joins its
    # partial results through these; a whole layer has nothing to join.
    def enter(self, h):
        return h

    def reduce(self, y):
        return y

    def gather_vocab(self, logits):
        return logits

    @property
    def expert_shard(self):
        return None

    def local_cache(self, cache):
        return cache

    def place_cache(self, cache):
        return cache


PRESETS: dict[str, DecoderConfig] = {
    # v0.1 family: sliding-window attention over the last 4096 positions
    "mistral-7b-instruct": DecoderConfig(sliding_window=4096),
    "mistralai/Mistral-7B-Instruct-v0.2": DecoderConfig(rope_theta=1e6),
    "tinyllama-1.1b": DecoderConfig(
        hidden=2048, layers=22, heads=32, kv_heads=4, intermediate=5632,
        max_len=2048,
    ),
    "mixtral-8x7b-instruct": DecoderConfig(
        rope_theta=1e6, experts=8, experts_top_k=2, max_len=8192,
    ),
    # tiny deterministic shape for tests: f32 so CPU numerics are exact
    "pw-tiny-decoder": DecoderConfig(
        vocab_size=512, hidden=64, layers=2, heads=4, kv_heads=2,
        intermediate=128, max_len=128, dtype=torch.float32,
    ),
    "pw-tiny-moe-decoder": DecoderConfig(
        vocab_size=512, hidden=64, layers=2, heads=4, kv_heads=2,
        intermediate=128, max_len=128, dtype=torch.float32,
        experts=4, experts_top_k=2,
    ),
}


def decoder_config_for(model_name: str) -> DecoderConfig:
    """Preset lookup, or the shape read from a local llama-family
    ``config.json`` (``transformers`` save directory)."""
    if model_name in PRESETS:
        return PRESETS[model_name]
    cfg_path = os.path.join(model_name, "config.json")
    if os.path.isfile(cfg_path):
        with open(cfg_path) as f:
            hf = json.load(f)
        return DecoderConfig(
            vocab_size=hf.get("vocab_size", 32000),
            hidden=hf.get("hidden_size", 4096),
            layers=hf.get("num_hidden_layers", 32),
            heads=hf.get("num_attention_heads", 32),
            kv_heads=hf.get("num_key_value_heads", hf.get("num_attention_heads", 32)),
            intermediate=hf.get("intermediate_size", 14336),
            max_len=min(hf.get("max_position_embeddings", 4096), 8192),
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
            experts=hf.get("num_local_experts", 0),
            experts_top_k=hf.get("num_experts_per_tok", 2),
            sliding_window=hf.get("sliding_window"),
        )
    # an unknown name would otherwise build a random 7B: fail loudly
    raise ValueError(
        f"unknown decoder model {model_name!r}: not a preset "
        f"({sorted(PRESETS)}) and not a local checkpoint directory"
    )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


# every matmul weight of the tree; lm_head is quantized with them
QUANT_NAMES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def _quant_matrix(w):
    """Symmetric per-output-channel int8 of float ``w [..., I, O]``:
    ``s = max|w| / 127`` over the contraction axis -2 (floored at 1e-12),
    ``q = clip(round(w / s), ±127)`` with round half to even.  Returns
    ``(q int8 [..., I, O], s f32 [..., 1, O])``."""
    w32 = w.float()
    s = (w32.abs().amax(dim=-2, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(w32 / s).clamp(-127, 127).to(torch.int8)
    return q, s


def _quantized(shape, device, matrix) -> dict:
    """``{"q", "s"}`` of a stacked weight of ``shape`` ``[..., I, O]``, made
    one matrix at a time: ``matrix(i)`` gives the i-th float matrix, so no
    float copy of the whole stack exists."""
    q = torch.empty(shape, dtype=torch.int8, device=device)
    s = torch.empty((*shape[:-2], 1, shape[-1]), dtype=torch.float32, device=device)
    for i, (qi, si) in enumerate(zip(q.view(-1, *shape[-2:]), s.view(-1, 1, shape[-1]))):
        qm, sm = _quant_matrix(matrix(i))
        qi.copy_(qm)
        si.copy_(sm)
    return {"q": q, "s": s}


def _quantize(w, dtype=None, device=None) -> dict:
    """``{"q", "s"}`` of a stacked float weight ``[..., I, O]``; each matrix
    is moved to ``device`` in ``dtype`` (default: ``w``'s), then quantized
    by :func:`_quant_matrix`."""
    mats = w.reshape(-1, *w.shape[-2:])
    device = w.device if device is None else device
    return _quantized(w.shape, device, lambda i: mats[i].to(device=device, dtype=dtype or w.dtype))


def quantize_decoder_tree(tree) -> dict:
    """Weight-only int8 quantization of a decoder param tree (serving).

    Every matmul weight (attention projections, dense or expert MLP,
    ``lm_head``) becomes ``{"q": int8, "s": f32}`` (:func:`_quant_matrix`);
    the embedding, the norms and the MoE router stay as they are (the same
    tensors).  A LoRA-adapted weight raises ``ValueError`` naming
    ``merge_lora``, as the JAX package's does."""
    for name in QUANT_NAMES:
        w = tree["layers"].get(name)
        if isinstance(w, dict) and "a" in w:
            raise ValueError(
                f"layer weight {name!r} carries LoRA adapters — call "
                "models.lora.merge_lora(tree) before quantizing (or "
                "before speculative decoding, which quantizes its draft)"
            )
    return {
        "embed": tree["embed"],
        "final_norm": tree["final_norm"],
        "lm_head": _quantize(tree["lm_head"]),
        "layers": {
            name: (_quantize(w) if name in QUANT_NAMES else w)
            for name, w in tree["layers"].items()
        },
    }


def init_decoder_params(cfg: DecoderConfig, seed: int = 0, device=None,
                        quantize: str | None = None) -> dict:
    """Seeded scaled-normal init of the stacked param tree, made on
    ``device`` with one ``torch.Generator``: the JAX tree's shapes and
    scales (normal / sqrt(fan_in), ones for the norms), drawn one matrix
    at a time so no f32 copy of a whole stacked weight exists.  The bits
    differ from the JAX package's for the same seed.

    ``quantize="int8"`` quantizes each matmul weight's matrix as it is
    drawn (and rounded to ``cfg.dtype``), so the float tree never exists
    whole: the codes and scales are those of :func:`quantize_decoder_tree`
    on the float init of the same seed."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    H, L, F_ = cfg.hidden, cfg.layers, cfg.intermediate
    NH, KH, D = cfg.heads, cfg.kv_heads, cfg.head_dim

    def normal(shape, fan_in, dtype=cfg.dtype):
        out = torch.empty(shape, dtype=dtype, device=device)
        for m in out.view(-1, shape[-2], shape[-1]):
            m.copy_(torch.randn(m.shape, generator=gen, device=device) / math.sqrt(fan_in))
        return out

    def weight(shape, fan_in):
        if quantize is None:
            return normal(shape, fan_in)

        def draw(_):
            m = torch.randn(shape[-2:], generator=gen, device=device) / math.sqrt(fan_in)
            return m.to(cfg.dtype)

        return _quantized(shape, device, draw)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    layers = {
        "ln0": ones((L, H)),
        "ln1": ones((L, H)),
        "wq": weight((L, H, NH * D), H),
        "wk": weight((L, H, KH * D), H),
        "wv": weight((L, H, KH * D), H),
        "wo": weight((L, NH * D, H), NH * D),
    }
    if cfg.experts:
        E = cfg.experts
        layers["moe_router"] = normal((L, H, E), H, dtype=torch.float32)
        layers["wg"] = weight((L, E, H, F_), H)
        layers["wu"] = weight((L, E, H, F_), H)
        layers["wd"] = weight((L, E, F_, H), F_)
    else:
        layers["wg"] = weight((L, H, F_), H)
        layers["wu"] = weight((L, H, F_), H)
        layers["wd"] = weight((L, F_, H), F_)
    return {
        "embed": normal((cfg.vocab_size, H), H),
        "final_norm": ones((H,)),
        "lm_head": weight((H, cfg.vocab_size), H),
        "layers": layers,
    }


def from_jax_decoder_params(tree, cfg: DecoderConfig, device) -> dict:
    """The port's tree from the JAX package's (nested dicts of arrays, e.g.
    ``jax.device_get`` output), on ``device``: float leaves in
    ``cfg.dtype``, the MoE router and int8 scales in f32 as in the JAX
    tree, and int8 codes as ``torch.int8``, so that a quantized tree
    carries across unchanged; a LoRA leaf's ``w``, ``a`` and ``b`` come
    across in ``cfg.dtype``, as the JAX tree holds them."""
    device = resolve_device(device)

    def convert(node, name=""):
        if hasattr(node, "items"):
            return {k: convert(v, k) for k, v in node.items()}
        if name == "q":
            return torch.from_numpy(np.array(node, np.int8)).to(device)
        dtype = torch.float32 if name in ("moe_router", "s") else cfg.dtype
        return torch.from_numpy(np.array(node, np.float32)).to(device=device, dtype=dtype)

    return convert(tree)


def _at(w, i: int):
    return {k: v[i] for k, v in w.items()} if isinstance(w, dict) else w[i]


def _layer(tree, i: int) -> dict:
    """Layer ``i``'s weights: views into the stacked tree (both the codes
    and the scales of an int8 weight)."""
    return {name: _at(w, i) for name, w in tree["layers"].items()}


def _unstack(w) -> list:
    if isinstance(w, dict):
        parts = {k: v.unbind(0) for k, v in w.items()}
        return [dict(zip(parts, vals)) for vals in zip(*parts.values())]
    return list(w.unbind(0))


def _layers(tree) -> list[dict]:
    """Every layer's weights, as :func:`_layer` gives them, from one
    ``unbind`` per stacked leaf: under autograd the backward then stacks
    each leaf's layer gradients once, where a view per layer would add a
    zero-filled gradient of the whole stack for every layer."""
    cols = {name: _unstack(w) for name, w in tree["layers"].items()}
    return [dict(zip(cols, vals)) for vals in zip(*cols.values())]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _rms(x, scale, eps):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _sw_mask(q_pos, k_pos, window: int):
    """True where key position ``k_pos`` lies inside the sliding window of
    query position ``q_pos`` (``q_pos - window < k_pos``); shapes
    broadcast.  The one definition of the window edge."""
    return k_pos > q_pos - window


def _mm(x, w):
    """``x @ w`` for a float weight, an int8 weight-only pair, or a
    LoRA-adapted weight.

    An int8 weight is ``{"q": int8, "s": f32}`` with per-output-channel
    scales over the contraction axis (-2 in every layout here), so the
    scale commutes with the product and multiplies the OUTPUT:
    ``(x @ q.to(x.dtype)) * s.to(x.dtype)``, in the JAX package's order.
    A LoRA weight is ``{"w": frozen base, "a": [..., H, r], "b": [..., r,
    O]}`` (``models/lora.py``): the update runs through the rank-``r``
    bottleneck, ``x @ w + (x @ a) @ b``, and the dense delta is never made."""
    if isinstance(w, dict) and "q" in w:
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    if isinstance(w, dict) and "a" in w:
        return x @ w["w"] + (x @ w["a"].to(x.dtype)) @ w["b"].to(x.dtype)
    return x @ w


def _rope_tables(positions, d: int, theta: float):
    """cos and sin ``[..., S, 1, D/2]`` of the rotary embedding at integer
    ``positions [..., S]``; computed once per forward, shared by layers."""
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d))
    freqs = positions[..., None].float() * inv
    return torch.cos(freqs)[..., None, :], torch.sin(freqs)[..., None, :]


def _apply_rope(x, cos, sin):
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _rope(x, positions, theta):
    """Rotary embedding; ``x`` is ``[..., S, H, D]``, positions ``[..., S]``."""
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1], theta))


def moe_config(cfg: DecoderConfig) -> MoEConfig:
    """The MoE layer config of an MoE decoder's FFN."""
    return MoEConfig(
        hidden=cfg.hidden,
        experts=cfg.experts,
        intermediate=cfg.intermediate,
        top_k=cfg.experts_top_k,
        capacity_factor=cfg.expert_capacity_factor,
        dtype=cfg.dtype,
    )


def moe_params(lp) -> dict:
    """One layer's router and expert weights, as ``moe_ffn`` takes them."""
    return {"router": lp["moe_router"], "wg": lp["wg"], "wu": lp["wu"], "wd": lp["wd"]}


def _ffn(lp, h, cfg: DecoderConfig, *, full_capacity: bool = False):
    """SwiGLU MLP: dense, or Mixtral-style sparse MoE when
    ``cfg.experts > 0`` (the GShard dispatch of ``parallel/moe.py``).
    Returns ``(y, aux)``: ``aux`` is the MoE load-balance loss, and 0.0
    for a dense MLP.  ``full_capacity`` selects the lossless dispatch that
    every serving path asks for (a capacity drop there would silently
    change the generation); training drops at capacity."""
    if cfg.experts:
        return moe_ffn(moe_params(lp), h, moe_config(cfg), full_capacity=full_capacity, shard=cfg.expert_shard)
    h = cfg.enter(h)
    return cfg.reduce(_mm(F.silu(_mm(h, lp["wg"])) * _mm(h, lp["wu"]), lp["wd"])), 0.0


def _qkv(lp, x, rope, cfg: DecoderConfig):
    """Pre-norm q ``[B, S, NH, D]`` and k, v ``[B, S, KH, D]``, rotated."""
    B, S = x.shape[0], x.shape[1]
    KH, D = cfg.kv_heads, cfg.head_dim
    h = cfg.enter(_rms(x, lp["ln0"], cfg.norm_eps))
    q = _apply_rope(_mm(h, lp["wq"]).reshape(B, S, cfg.heads, D), *rope)
    k = _apply_rope(_mm(h, lp["wk"]).reshape(B, S, KH, D), *rope)
    v = _mm(h, lp["wv"]).reshape(B, S, KH, D)
    return q, k, v


def _finish_layer(lp, x, ctx, cfg: DecoderConfig, *, full_capacity: bool = False):
    """Output projection, residual, and the MLP half of the block;
    returns ``(x, aux)`` with the MLP's aux loss (see :func:`_ffn`)."""
    x = x + cfg.reduce(_mm(ctx, lp["wo"]))
    mlp, aux = _ffn(lp, _rms(x, lp["ln1"], cfg.norm_eps), cfg, full_capacity=full_capacity)
    return x + mlp, aux


def decoder_layer(lp, x, rope, mask, cfg: DecoderConfig, *, full_capacity: bool = False):
    """One pre-norm transformer block (GQA attention + SwiGLU/MoE MLP).

    ``lp`` holds a single layer's weights, ``rope`` the ``(cos, sin)``
    tables of :func:`_rope_tables` at the block's positions, ``mask``
    ``[B, S, S]`` boolean (True = attend).  Returns ``(x, (k, v), aux)``:
    the new residual stream, this layer's keys and values ``[B, S, KH,
    D]`` and its MoE aux loss (0.0 for a dense MLP).  ``full_capacity``
    selects lossless MoE dispatch (serving).
    """
    q, k, v = _qkv(lp, x, rope, cfg)
    x, aux = _finish_layer(lp, x, _attend(q, k, v, mask), cfg, full_capacity=full_capacity)
    return x, (k, v), aux


def _causal_trunk(tree, ids, lengths, cfg: DecoderConfig, cache_len: int | None, *,
                  full_capacity: bool = False):
    """Shared causal forward: ``(x, k_cache, v_cache, aux)``, the
    final-norm token reps, K/V caches ``[L, B, cache_len, KH, D]`` holding
    the prompt at ``[0, S)`` and zeros past each row's length, and the MoE
    aux loss summed over the layers (0.0 for dense configs).

    ``cache_len=None`` is the training forward: no cache is made (the
    caches are ``None``; XLA drops them as dead code under ``grad``, an
    eager forward would allocate them), and with ``cfg.remat`` each layer
    runs under ``torch.utils.checkpoint`` while grad is enabled, the
    counterpart of ``jax.checkpoint`` over the JAX package's scan body."""
    B, S = ids.shape
    dev = ids.device
    x = tree["embed"][ids]  # [B, S, H]
    pos = torch.arange(S, device=dev)
    positions = pos[None, :].expand(B, S)
    valid = positions < lengths[:, None]  # [B, S]
    causal = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    if cfg.sliding_window is not None:
        causal = causal & _sw_mask(pos[:, None], pos[None, :], cfg.sliding_window)
    mask = causal[None, :, :] & valid[:, None, :]  # [B, S(q), S(kv)]
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    aux = 0.0
    if cache_len is None:
        layer = functools.partial(decoder_layer, rope=rope, mask=mask, cfg=cfg, full_capacity=full_capacity)
        remat = cfg.remat and torch.is_grad_enabled()
        for lp in _layers(tree):
            if remat:
                x, _, a = torch.utils.checkpoint.checkpoint(layer, lp, x, use_reentrant=False)
            else:
                x, _, a = layer(lp, x)
            aux = aux + a
        return _rms(x, tree["final_norm"], cfg.norm_eps), None, None, aux
    shape = (cfg.layers, B, cache_len, cfg.kv_heads, cfg.head_dim)
    k_cache = torch.zeros(shape, dtype=x.dtype, device=dev)
    v_cache = torch.zeros(shape, dtype=x.dtype, device=dev)
    # zero K/V beyond each row's real length: decode steps only write
    # their own position, so untouched slots must hold zeros
    keep = valid[:, :, None, None].to(x.dtype)
    for i, lp in enumerate(_layers(tree)):
        x, (k, v), a = decoder_layer(lp, x, rope, mask, cfg, full_capacity=full_capacity)
        k_cache[i, :, :S] = k * keep
        v_cache[i, :, :S] = v * keep
        aux = aux + a
    return _rms(x, tree["final_norm"], cfg.norm_eps), k_cache, v_cache, aux


def _logits(tree, x, cfg: DecoderConfig):
    return cfg.gather_vocab(_mm(cfg.enter(x), tree["lm_head"]).float())


def prefill(tree, ids, lengths, cfg: DecoderConfig, cache_len: int):
    """Causal forward over the whole (padded) prompt.

    Returns ``(logits_last, k_cache, v_cache)``: f32 logits at each row's
    final real token and caches of shape ``[L, B, cache_len, KH, D]`` with
    the prompt keys/values written at positions ``[0, S)``.  A placed tree
    (:func:`place_tp_params`) returns the whole logits on every rank and
    its caches as DTensors split over the kv heads, which
    :func:`decode_step` takes back.
    """
    # serving path: lossless MoE dispatch, as in every step below
    tree, cfg = shard_view(tree, cfg)
    x, k_cache, v_cache, _ = _causal_trunk(tree, ids, lengths, cfg, cache_len, full_capacity=True)
    last = x[torch.arange(ids.shape[0], device=ids.device), lengths - 1]
    return _logits(tree, last, cfg), cfg.place_cache(k_cache), cfg.place_cache(v_cache)


def causal_lm_logits(tree, ids, lengths, cfg: DecoderConfig):
    """All-position logits ``[B, S, vocab]`` (f32) for next-token
    training: the forward of :func:`causal_lm_logits_and_aux`."""
    return causal_lm_logits_and_aux(tree, ids, lengths, cfg)[0]


def causal_lm_logits_and_aux(tree, ids, lengths, cfg: DecoderConfig):
    """``(logits [B, S, vocab] f32, aux)``: aux is the MoE load-balance
    loss summed over the layers (a 0 tensor for dense configs), which MoE
    training adds to the LM loss so routing stays spread over experts.
    The MoE layers drop tokens at capacity, as the JAX package's training
    forward does; no K/V cache is made."""
    tree, cfg = shard_view(tree, cfg)
    x, _, _, aux = _causal_trunk(tree, ids, lengths, cfg, None)
    logits = _logits(tree, x, cfg)
    return logits, torch.as_tensor(aux, dtype=torch.float32, device=logits.device)


def decode_step(tree, k_cache, v_cache, token, pos, cfg: DecoderConfig):
    """One generation step: ``token`` ``[B]`` at position ``pos`` ``[B]``.

    Writes the new K/V at ``pos`` into the caches in place and returns
    ``(logits, k_cache, v_cache)``.  A row whose ``pos`` is past the cache
    writes nothing, as the JAX package's one-hot write does.
    """
    tree, cfg = shard_view(tree, cfg)
    k_local, v_local = cfg.local_cache(k_cache), cfg.local_cache(v_cache)
    B = token.shape[0]
    C = k_local.shape[2]
    dev = token.device
    x = tree["embed"][token][:, None, :]  # [B, 1, H]
    idx = torch.arange(C, device=dev)[None, None, :]
    mask = idx <= pos[:, None, None]  # [B, 1, C]
    if cfg.sliding_window is not None:
        mask = mask & _sw_mask(pos[:, None, None], idx, cfg.sliding_window)
    rope = _rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    rows = torch.arange(B, device=dev)
    inside = (pos < C)[:, None, None]
    at = pos.clamp(max=C - 1)
    for i in range(cfg.layers):
        lp, kc, vc = _layer(tree, i), k_local[i], v_local[i]
        q, k, v = _qkv(lp, x, rope, cfg)
        kc[rows, at] = torch.where(inside, k[:, 0], kc[rows, at])
        vc[rows, at] = torch.where(inside, v[:, 0], vc[rows, at])
        x, _ = _finish_layer(lp, x, _attend(q, kc, vc, mask), cfg, full_capacity=True)
    x = _rms(x, tree["final_norm"], cfg.norm_eps)
    return _logits(tree, x[:, 0, :], cfg), k_cache, v_cache


# ---------------------------------------------------------------------------
# Tensor parallelism (the Megatron layout)
# ---------------------------------------------------------------------------


def tp_param_specs(cfg: DecoderConfig, axis: str = "model") -> dict:
    """The JAX package's tensor-parallel layout, leaf for leaf, as
    ``PartitionSpec`` tuples (``parallel/sharding.py``): ``wq``/``wk``/
    ``wv``/``wg``/``wu`` split on their output dim, ``wo``/``wd`` on their
    input dim, ``lm_head`` on the vocab, the rest replicated.  An MoE
    config splits the expert axis of ``wg``/``wu``/``wd`` instead (each rank
    owns ``E / |axis|`` whole experts) and replicates the router."""
    layers = {
        "ln0": (None, None),
        "ln1": (None, None),
        "wq": (None, None, axis),
        "wk": (None, None, axis),
        "wv": (None, None, axis),
        "wo": (None, axis, None),
    }
    if cfg.experts:
        layers.update(moe_router=(None, None, None), wg=(None, axis, None, None), wu=(None, axis, None, None),
                      wd=(None, axis, None, None))
    else:
        layers.update(wg=(None, None, axis), wu=(None, None, axis), wd=(None, axis, None))
    return {"embed": (None, None), "final_norm": (None,), "lm_head": (None, axis), "layers": layers}


def tp_cache_specs(axis: str = "model") -> tuple:
    """The KV cache ``[L, B, C, KH, D]`` split over its kv heads."""
    return (None, None, None, axis, None)


def place_tp_params(tree, cfg: DecoderConfig, mesh, axis: str = "model") -> PlacedTree:
    """``tree`` (the same full tree on every rank) placed on ``mesh`` by
    :func:`tp_param_specs`: each rank keeps its shards.  A float tree only:
    a LoRA or int8 leaf raises ``ValueError``, as the JAX spec tree cannot
    map one either."""
    return PlacedTree(place_tree(tree, mesh, tp_param_specs(cfg, axis)), cfg)


@dataclasses.dataclass(frozen=True)
class ShardConfig(DecoderConfig):
    """One rank's share of a mesh-placed decoder (:func:`shard_view`).

    ``heads`` and ``kv_heads`` are the rank's (``head_dim`` stays the
    model's); an MoE layer keeps ``experts`` (every token is routed over
    all of them) and runs the rank's ``experts / model_size`` from
    ``expert_first``.  The joins are Megatron's: a replicated activation
    enters a split matmul through ``copy_to`` and the partial sums leave
    through ``reduce_from`` over ``model_group``; the vocab-split logits are
    gathered.  With ``data_group`` the batch is the rank's rows of the
    global one, and the MoE layers gather the tokens over it, so that
    routing and capacity follow the global token order."""

    shard_head_dim: int = 0
    model_size: int = 1
    expert_first: int = 0
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    cache_placements: tuple = ()

    @property
    def head_dim(self) -> int:
        return self.shard_head_dim

    def enter(self, h):
        return h if self.model_group is None else copy_to(h, self.model_group)

    def reduce(self, y):
        return y if self.model_group is None else reduce_from(y, self.model_group)

    def gather_vocab(self, logits):
        return logits if self.model_group is None else gather_from(logits, self.model_group, -1)

    @property
    def expert_shard(self):
        if not self.experts:
            return None
        return ExpertShard(self.model_group, self.expert_first, self.experts // self.model_size, self.data_group)

    def local_cache(self, cache):
        return cache.to_local()

    def place_cache(self, cache):
        """The rank's cache ``[L, B, C, KH, D]`` as a DTensor: kv heads over
        the model axis (:func:`tp_cache_specs`), rows over ``data``."""
        shape = list(cache.shape)
        for dim, p in enumerate(self.cache_placements):
            if p.is_shard():
                shape[p.dim] *= self.mesh.size(dim)
        return DTensor.from_local(cache, self.mesh, self.cache_placements, run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())


def _leaf_items(tree, path=()):
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _leaf_items(node, path + (key,))
        else:
            yield path + (key,), node


class PlacedTree(dict):
    """A mesh-placed decoder tree (a dict of its leaves, as placed) that
    carries its rank's :class:`ShardConfig` for ``cfg``, checked and worked
    out once, here, so the steps that take the tree do not redo it."""

    def __init__(self, tree, cfg: DecoderConfig):
        super().__init__(tree)
        self.cfg = cfg
        self.view = _shard_config(self, cfg)


def shard_view(tree, cfg: DecoderConfig):
    """``(local tree, ShardConfig)`` of a tree placed on a mesh (every leaf
    a DTensor, laid out by :func:`tp_param_specs` over one mesh axis, or
    replicated); ``(tree, cfg)`` unchanged for a tree of plain tensors.
    The local tree holds each leaf's ``to_local()`` (differentiable), so a
    gradient reaches the placed leaves.  A :class:`PlacedTree` gives the
    view it worked out at placement; any other placed tree is checked on
    every call."""
    if not isinstance(tree["embed"], DTensor):
        return tree, cfg
    if isinstance(tree, PlacedTree) and (tree.cfg is cfg or tree.cfg == cfg):
        view = tree.view
    else:
        view = _shard_config(tree, cfg)
    local = {k: (_map_leaves(lambda t: t.to_local(), v) if isinstance(v, dict) else v.to_local())
             for k, v in tree.items()}
    return local, view


def _shard_config(tree, cfg: DecoderConfig) -> ShardConfig:
    """The rank's :class:`ShardConfig` of a placed tree.  A leaf placed
    otherwise than :func:`shard_view` takes, or heads that do not split
    evenly, raise ``ValueError``."""
    mesh = tree["embed"].device_mesh
    names = mesh.mesh_dim_names
    head = tree["lm_head"]
    axis = next((names[d] for d, p in enumerate(head.placements) if p.is_shard(1)), None) \
        if isinstance(head, DTensor) else None
    specs = dict(_leaf_items(tp_param_specs(cfg, axis))) if axis else {}
    for path, leaf in _leaf_items(tree):
        want = spec_placements(specs.get(path[:2] if path[0] == "layers" else path[:1], ()), mesh)
        if not isinstance(leaf, DTensor) or leaf.device_mesh != mesh or tuple(leaf.placements) != want:
            got = tuple(leaf.placements) if isinstance(leaf, DTensor) else type(leaf).__name__
            raise ValueError(f"leaf {'/'.join(path)!r} is placed {got}, not {want}: place the tree with "
                             "place_tp_params (tensor parallel) or place_tree (replicated)")
    m = mesh.size(names.index(axis)) if axis else 1
    if cfg.heads % m or cfg.kv_heads % m:
        raise ValueError(f"{cfg.heads} heads and {cfg.kv_heads} kv heads do not split over {m} ranks")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(DecoderConfig)}
    fields.update(heads=cfg.heads // m, kv_heads=cfg.kv_heads // m)
    cache = {3: axis, 1: "data" if "data" in names and axis != "data" else None}
    return ShardConfig(
        **fields,
        shard_head_dim=cfg.head_dim,
        model_size=m,
        expert_first=mesh.get_local_rank(axis) * (cfg.experts // m) if axis else 0,
        mesh=mesh,
        model_group=mesh.get_group(axis) if axis else None,
        data_group=mesh.get_group("data") if cache[1] else None,
        cache_placements=spec_placements(tuple(cache.get(d) for d in range(5)), mesh),
    )


def _map_leaves(fn, node):
    return {k: _map_leaves(fn, v) for k, v in node.items()} if isinstance(node, dict) else fn(node)


def _plain_only(tree, what: str) -> None:
    if isinstance(tree["embed"], DTensor):
        raise NotImplementedError(
            f"{what} has no tensor-parallel form: a mesh-placed tree runs through prefill and decode_step"
        )


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def _filter_logits(lg, *, top_k: int | None = None, top_p=None, min_p=None):
    """Set the logits that min-p, top-k and top-p reject to -inf, in the JAX
    package's order.  ``top_p`` and ``min_p`` are floats or tensors that
    broadcast against ``lg [B, V]`` (per-row values as ``[B, 1]``)."""
    neg_inf = float("-inf")
    if min_p is not None:
        # log-space form of probs < min_p * max(probs); min_p > 1 degrades
        # to argmax-only, min_p = 0 gives log 0 = -inf, a no-op
        mp = torch.as_tensor(min_p, dtype=lg.dtype, device=lg.device).clamp(max=1.0)
        cut = lg.amax(dim=-1, keepdim=True) + torch.log(mp)
        lg = lg.masked_fill(lg < cut, neg_inf)
    if top_k is not None:
        # an oversized k degrades to "no truncation"
        kth = torch.topk(lg, min(int(top_k), lg.shape[-1]), dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, neg_inf)
    if top_p is not None:
        sorted_lg = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lg, dim=-1)
        # exclusive prefix mass: token i survives while the mass before it
        # is still < top_p; the top token always survives
        before = torch.cumsum(probs, dim=-1) - probs
        keep = before < torch.as_tensor(top_p, dtype=lg.dtype, device=lg.device)
        keep[..., 0] = True
        kept_min = torch.where(keep, sorted_lg, float("inf")).amin(dim=-1, keepdim=True)
        lg = lg.masked_fill(lg < kept_min, neg_inf)
    return lg


def sample_logits(logits, generator, temp, *, top_k: int | None = None,
                  top_p=None, min_p=None):
    """Temperature, then optional min-p / top-k / top-p truncation, then a
    categorical draw from ``generator``.  ``logits [B, V]`` f32; ``temp``,
    ``top_p`` and ``min_p`` are floats or ``[B, 1]`` tensors.  Returns
    ``[B]`` int64 token ids.  The draws differ from ``jax.random``'s; the
    support the filters leave is the same."""
    lg = _filter_logits(logits / temp, top_k=top_k, top_p=top_p, min_p=min_p)
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def apply_repetition_penalty(logits, seen, penalty):
    """HF-semantics repetition penalty: logits of already-seen tokens
    (``seen [B, V]`` bool) divide by ``penalty`` when positive, multiply
    when negative; 1.0 is a no-op."""
    scaled = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, scaled, logits)


def decode_chunk(
    tree,
    k_cache,
    v_cache,
    logits,
    pos,
    done,
    generator,
    temp,
    cfg: DecoderConfig,
    n_steps: int,
    greedy: bool,
    eos_id: int | None,
    top_k: int | None = None,
    top_p=None,
    min_p=None,
    rep_penalty=None,
    seen=None,
):
    """``n_steps`` sample → decode steps with sampling and EOS masking on
    the device and no host sync: the caller syncs once per chunk.

    Returns ``(toks [n_steps, B], valid [n_steps, B], logits, k_cache,
    v_cache, pos, done, seen)``; ``valid`` marks tokens the caller should
    append (False once a row has finished or sampled EOS).  Rows past
    their EOS keep stepping; their emissions are masked.  ``seen`` is
    ``None`` unless ``rep_penalty`` is given.
    """
    toks, valids = [], []
    for _ in range(n_steps):
        lg = logits if rep_penalty is None else apply_repetition_penalty(logits, seen, rep_penalty)
        if greedy:
            tok = lg.argmax(dim=-1)
        else:
            tok = sample_logits(lg, generator, temp, top_k=top_k, top_p=top_p, min_p=min_p)
        stop = tok == eos_id if eos_id is not None else torch.zeros_like(done)
        valids.append(~done & ~stop)
        toks.append(tok)
        done = done | stop
        logits, k_cache, v_cache = decode_step(tree, k_cache, v_cache, tok, pos, cfg)
        pos = pos + 1
        if rep_penalty is not None:
            seen = seen.scatter(1, tok[:, None], True)
    return torch.stack(toks), torch.stack(valids), logits, k_cache, v_cache, pos, done, seen


# ---------------------------------------------------------------------------
# Paged KV cache (continuous-batching serving path)
# ---------------------------------------------------------------------------
#
# The paged layout stores KV in fixed-size PAGES of a preallocated pool
# ([L, P, page, KH, D]) with a per-slot block table mapping logical
# positions onto pages, so cache memory scales with live tokens.  Page 0
# is the reserved null page: unallocated block-table entries point at it,
# padding writes land in it, and no slot's attention mask reaches into it.


def init_kv_pool(cfg: DecoderConfig, num_pages: int, page_size: int, device=None):
    """Preallocate the paged KV pool: ``(k_pool, v_pool)``, each
    ``[L, num_pages, page_size, KH, D]``.  Page 0 is the null page."""
    device = resolve_device(device)
    shape = (cfg.layers, num_pages, page_size, cfg.kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


class PageExhaustedError(RuntimeError):
    """The pool has no free page — admission control must keep the sum of
    reserved pages within the pool, so hitting this mid-generation is a
    scheduler bug, not an overload condition."""


class PageAllocator:
    """Host-side free-list allocator over the page pool.

    Tracks which pool pages are free (page 0 is reserved as the null
    page), reservations, and live/peak KV byte accounting."""

    def __init__(self, num_pages: int, page_size: int, bytes_per_token: int):
        if num_pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is the null page)")
        self.num_pages = num_pages
        self.page_size = page_size
        self.bytes_per_token = bytes_per_token  # both K and V, all layers
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self.reserved = 0  # admission-reserved pages (not yet allocated)
        self.peak_pages = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def pages_for(self, tokens: int) -> int:
        return -(-max(tokens, 1) // self.page_size)

    def can_reserve(self, pages: int) -> bool:
        return self.reserved + pages <= len(self._free)

    def reserve(self, pages: int) -> None:
        """Set aside a request's worst case (prompt + max_new_tokens) at
        admission, so a mid-generation allocation can never fail."""
        if not self.can_reserve(pages):
            raise PageExhaustedError(
                f"cannot reserve {pages} page(s): {len(self._free)} free, "
                f"{self.reserved} already reserved"
            )
        self.reserved += pages

    def alloc(self, *, reserved: bool = True) -> int:
        """Take one free page (consuming one unit of reservation when
        ``reserved``); pages are handed out as tokens arrive."""
        if not self._free:
            raise PageExhaustedError("page pool exhausted")
        page = self._free.pop()
        if reserved:
            self.reserved -= 1
        self.peak_pages = max(self.peak_pages, self.used_pages)
        return page

    def release(self, pages: list[int], *, unreserve: int = 0) -> None:
        """Return a slot's pages (and any unused reservation) to the pool."""
        self._free.extend(pages)
        self.reserved -= unreserve

    @property
    def live_bytes(self) -> int:
        return self.used_pages * self.page_size * self.bytes_per_token

    @property
    def peak_bytes(self) -> int:
        return self.peak_pages * self.page_size * self.bytes_per_token


def kv_bytes_per_token(cfg: DecoderConfig) -> int:
    """K + V bytes one token occupies across all layers."""
    return 2 * cfg.layers * cfg.kv_heads * cfg.head_dim * cfg.dtype.itemsize


def _paged_layers(tree, k_pool, v_pool, x, rope, rows, block_tables, mask, cfg, *,
                  full_capacity: bool):
    """The layer loop of both paged steps: write this block's K/V at pool
    ``rows`` (see :func:`attention_ops.kv_rows`), attend over the slots'
    pages.  Returns the final-norm token reps."""
    for i in range(cfg.layers):
        lp, kp, vp = _layer(tree, i), k_pool[i], v_pool[i]
        q, k, v = _qkv(lp, x, rope, cfg)
        attention_ops.write_kv_rows(kp, rows, k)
        attention_ops.write_kv_rows(vp, rows, v)
        ctx = attention_ops.paged_gqa_attention(q, kp, vp, block_tables, mask)
        x, _ = _finish_layer(lp, x, ctx, cfg, full_capacity=full_capacity)
    return _rms(x, tree["final_norm"], cfg.norm_eps)


def paged_decode_step(tree, k_pool, v_pool, block_tables, seq_lens, token,
                      cfg: DecoderConfig):
    """One generation step over paged KV: ``token`` ``[S]`` is written at
    each slot's next position (``seq_lens`` ``[S]``), attention gathers
    the slot's pages.  Returns ``(logits [S, V], k_pool, v_pool)``, the
    pools updated in place.

    The same math as :func:`decode_step` over the gathered context.
    Inactive slots (block table all null) write into and gather from the
    null page: finite garbage, masked everywhere.
    """
    _plain_only(tree, "paged_decode_step")
    page = k_pool.shape[2]
    C = block_tables.shape[1] * page
    x = tree["embed"][token][:, None, :]  # [S, 1, H]
    positions = seq_lens[:, None]  # [S, 1]
    idx = torch.arange(C, device=token.device)[None, None, :]
    mask = idx <= seq_lens[:, None, None]  # [S, 1, C]
    if cfg.sliding_window is not None:
        mask = mask & _sw_mask(seq_lens[:, None, None], idx, cfg.sliding_window)
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    rows = attention_ops.kv_rows(block_tables, positions, page)
    x = _paged_layers(tree, k_pool, v_pool, x, rope, rows, block_tables, mask, cfg, full_capacity=True)
    return _logits(tree, x[:, 0, :], cfg), k_pool, v_pool


def paged_prefill_chunk(tree, k_pool, v_pool, block_tables, chunk_ids,
                        chunk_lens, start, cfg: DecoderConfig):
    """Prefill ONE chunk of each slot's prompt against paged KV.

    ``chunk_ids`` ``[S, T]`` holds the next ``chunk_lens[s]`` prompt
    tokens of each slot (ragged; 0-padded), starting at logical position
    ``start[s]``.  The chunk's K/V goes into the slot's pages, then each
    chunk query attends causally over the slot's whole context so far.
    Returns ``(logits [S, V]`` at each slot's last chunk token``, k_pool,
    v_pool)``; rows with ``chunk_lens == 0`` give garbage logits the
    scheduler ignores.
    """
    _plain_only(tree, "paged_prefill_chunk")
    S, T = chunk_ids.shape
    dev = chunk_ids.device
    page = k_pool.shape[2]
    C = block_tables.shape[1] * page
    x = tree["embed"][chunk_ids]  # [S, T, H]
    t = torch.arange(T, device=dev)
    positions = start[:, None] + t[None, :]  # [S, T]
    valid_q = t[None, :] < chunk_lens[:, None]  # [S, T]
    # padding queries (including whole rows of slots that are decoding)
    # must write to the null page, never into a slot's live pages
    write_positions = torch.where(valid_q, positions, 2**30)
    idx = torch.arange(C, device=dev)[None, None, :]
    mask = (idx <= positions[:, :, None]) & valid_q[:, :, None]
    if cfg.sliding_window is not None:
        mask = mask & _sw_mask(positions[:, :, None], idx, cfg.sliding_window)
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    rows = attention_ops.kv_rows(block_tables, write_positions, page)
    x = _paged_layers(tree, k_pool, v_pool, x, rope, rows, block_tables, mask, cfg, full_capacity=True)
    last = x[torch.arange(S, device=dev), (chunk_lens - 1).clamp(min=0)]
    return _logits(tree, last, cfg), k_pool, v_pool


# ---------------------------------------------------------------------------
# Self-speculative decoding
# ---------------------------------------------------------------------------


def verify_block(tree, k_cache, v_cache, tokens, pos0, cfg: DecoderConfig):
    """Forward ``K`` already-chosen tokens against the cache in ONE pass.

    ``tokens [B, K]`` sit at positions ``pos0 + 0..K-1`` (``pos0 [B]``,
    ``K <= C``); the caches hold history for positions ``< pos0`` and zeros
    at the block's positions.  Writes the block's K/V into the caches in
    place and returns ``(logits [B, K, V] f32, k_cache, v_cache)``: what
    ``K`` sequential :func:`decode_step` calls give, as one batched sweep.
    A write at a position ``>= C`` is a no-op, as the JAX package's one-hot
    scatter is.
    """
    _plain_only(tree, "verify_block")
    B, K = tokens.shape
    C = k_cache.shape[2]
    dev = tokens.device
    x = tree["embed"][tokens]  # [B, K, H]
    positions = pos0[:, None] + torch.arange(K, device=dev)[None, :]  # [B, K]
    idx = torch.arange(C, device=dev)[None, None, :]
    # query i attends to every slot <= its own position (the block's K/V
    # are written before attending, so intra-block edges are included)
    mask = idx <= positions[:, :, None]  # [B, K, C]
    if cfg.sliding_window is not None:
        mask = mask & _sw_mask(positions[:, :, None], idx, cfg.sliding_window)
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    rows = torch.arange(B, device=dev)[:, None]
    inside = (positions < C)[:, :, None, None]
    # a row's K consecutive positions are distinct modulo C: a position past
    # the cache writes the value already at its wrapped slot back, and no
    # two writes of one call meet at one slot
    at = positions % C
    for i in range(cfg.layers):
        lp, kc, vc = _layer(tree, i), k_cache[i], v_cache[i]
        q, k, v = _qkv(lp, x, rope, cfg)
        kc[rows, at] = torch.where(inside, k, kc[rows, at])
        vc[rows, at] = torch.where(inside, v, vc[rows, at])
        x, _ = _finish_layer(lp, x, _attend(q, kc, vc, mask), cfg, full_capacity=True)
    x = _rms(x, tree["final_norm"], cfg.norm_eps)
    return _logits(tree, x, cfg), k_cache, v_cache


def speculative_decode_chunk(tree, draft_tree, k_cache, v_cache, logits, pos,
                             cfg: DecoderConfig, n_draft: int, done=None, *,
                             draft_cache):
    """One greedy speculative round: draft ``n_draft`` tokens with
    ``draft_tree`` (sequential single-token decodes), verify them against
    ``tree`` with ONE :func:`verify_block` sweep, and accept the longest
    prefix on which the target's own argmax agrees.

    The emitted chain is the target's greedy chain: ``toks[:, 0]`` is the
    argmax of the incoming (target) logits, and each further draft token
    counts only if the target's argmax at the preceding position agrees.
    At least one token is accepted per round.

    The draft steps write K/V, and :func:`decode_step` writes in place, so
    they run on a COPY of the target's caches: ``draft_cache``, a
    preallocated ``(k, v)`` pair of the same shape, refreshed with
    ``copy_`` each round.  The target's caches change only through the
    verify sweep.  Only ``n_draft - 1`` draft steps are run: the logits after the
    last draft token are never read.

    Returns ``(toks [B, n_draft], n_match [B], next_logits, k_cache,
    v_cache, pos + n_match)``: ``toks[b, :n_match[b]]`` are the accepted
    tokens, the caches hold target K/V for exactly the accepted positions
    (rejected positions are zeroed, so the slots stay ready for the next
    write) and ``next_logits`` are the target logits after the last
    accepted token.  ``done [B] bool`` freezes finished rows: their
    ``n_match`` is 0, ``pos`` does not advance and every write of the
    round is zeroed again, so their cache rows stay bit-identical.
    """
    B = logits.shape[0]
    C = k_cache.shape[2]
    dk, dv = draft_cache
    dk.copy_(k_cache)
    dv.copy_(v_cache)
    tok = logits.argmax(dim=-1)
    toks, lg, p = [tok], logits, pos
    for _ in range(n_draft - 1):
        lg, dk, dv = decode_step(draft_tree, dk, dv, tok, p, cfg)
        tok = lg.argmax(dim=-1)
        toks.append(tok)
        p = p + 1
    toks = torch.stack(toks, dim=1)  # [B, n_draft]

    vlogits, k_cache, v_cache = verify_block(tree, k_cache, v_cache, toks, pos, cfg)
    pred = vlogits.argmax(dim=-1)  # the target's next token after each block token
    match = (toks[:, 1:] == pred[:, :-1]).long()
    n_match = 1 + match.cumprod(dim=1).sum(dim=1)  # [B] 1..n_draft
    if done is not None:
        n_match = torch.where(done, 0, n_match)
    next_logits = vlogits[torch.arange(B, device=logits.device), (n_match - 1).clamp(min=0)]
    cidx = torch.arange(C, device=logits.device)[None, :]
    rejected = (cidx >= (pos + n_match)[:, None]) & (cidx < (pos + n_draft)[:, None])  # [B, C]
    k_cache.masked_fill_(rejected[None, :, :, None, None], 0)
    v_cache.masked_fill_(rejected[None, :, :, None, None], 0)
    return toks, n_match, next_logits, k_cache, v_cache, pos + n_match


# ---------------------------------------------------------------------------
# Checkpoint mapping
# ---------------------------------------------------------------------------


def map_hf_decoder_state_dict(sd: dict, cfg: DecoderConfig, device=None,
                              quantize: str | None = None) -> dict | None:
    """A llama/mistral-family ``state_dict`` (names → numpy arrays) mapped
    onto the stacked tree on ``device``, or ``None`` when its layout does
    not fit ``cfg``.

    The JAX ``load_hf_decoder_weights`` rules: torch ``Linear`` weights
    (``[out, in]``) are transposed into matmul layout; the Mixtral
    ``block_sparse_moe`` layout maps ``w1→wg``, ``w3→wu``, ``w2→wd`` and
    ``gate→moe_router`` (f32); ``lm_head`` falls back to the tied embedding.
    Float leaves are in ``cfg.dtype``.  ``quantize="int8"`` quantizes each
    matmul weight one matrix at a time as it is moved (the bits of
    :func:`quantize_decoder_tree` on the float tree)."""
    device = resolve_device(device)
    if "model.layers.0.self_attn.q_proj.weight" not in sd:
        return None
    if bool(cfg.experts) != ("model.layers.0.block_sparse_moe.gate.weight" in sd):
        return None  # a dense checkpoint for an MoE config, or the reverse

    def leaf(arr, dtype=cfg.dtype):
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device=device, dtype=dtype)

    def weight(arr):
        if quantize is None:
            return leaf(arr)
        return _quantize(torch.from_numpy(np.ascontiguousarray(arr, np.float32)), cfg.dtype, device)

    def stack(fmt, transpose=True):
        mats = [sd[fmt.format(i)] for i in range(cfg.layers)]
        return np.stack([m.T if transpose else m for m in mats])

    def stack_experts(wname):
        return np.stack([
            np.stack([sd[f"model.layers.{i}.block_sparse_moe.experts.{e}.{wname}.weight"].T
                      for e in range(cfg.experts)])
            for i in range(cfg.layers)
        ])

    layers = {
        "ln0": leaf(stack("model.layers.{}.input_layernorm.weight", transpose=False)),
        "ln1": leaf(stack("model.layers.{}.post_attention_layernorm.weight", transpose=False)),
        "wq": weight(stack("model.layers.{}.self_attn.q_proj.weight")),
        "wk": weight(stack("model.layers.{}.self_attn.k_proj.weight")),
        "wv": weight(stack("model.layers.{}.self_attn.v_proj.weight")),
        "wo": weight(stack("model.layers.{}.self_attn.o_proj.weight")),
    }
    if cfg.experts:
        layers["moe_router"] = leaf(stack("model.layers.{}.block_sparse_moe.gate.weight"), torch.float32)
        layers["wg"] = weight(stack_experts("w1"))
        layers["wu"] = weight(stack_experts("w3"))
        layers["wd"] = weight(stack_experts("w2"))
    else:
        layers["wg"] = weight(stack("model.layers.{}.mlp.gate_proj.weight"))
        layers["wu"] = weight(stack("model.layers.{}.mlp.up_proj.weight"))
        layers["wd"] = weight(stack("model.layers.{}.mlp.down_proj.weight"))
    lm_head = sd.get("lm_head.weight", sd["model.embed_tokens.weight"])
    return {
        "embed": leaf(sd["model.embed_tokens.weight"]),
        "final_norm": leaf(sd["model.norm.weight"]),
        "lm_head": weight(lm_head.T),
        "layers": layers,
    }


def load_hf_decoder_weights(model_name: str, cfg: DecoderConfig, device=None,
                            quantize: str | None = None) -> dict | None:
    """A locally cached llama/mistral-family ``transformers`` checkpoint
    mapped onto the tree (:func:`map_hf_decoder_state_dict`), or ``None``
    when there is none: no local directory or model cache, no
    ``transformers`` (imported here, never when the module is imported),
    or a load that fails.  Nothing is downloaded."""
    cache = os.path.expanduser(os.environ.get("HF_HOME", "~/.cache/huggingface"))
    if not os.path.isdir(model_name) and not os.path.isdir(cache):
        return None  # no local checkpoint can exist: skip the import
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    try:
        from transformers import AutoModelForCausalLM

        hf = AutoModelForCausalLM.from_pretrained(model_name, local_files_only=True)
    except Exception:  # noqa: BLE001 -- any failure to load means "no checkpoint"
        _log.debug("no local checkpoint for %s", model_name, exc_info=True)
        return None
    sd = {k: v.detach().float().cpu().numpy() for k, v in hf.state_dict().items()}
    del hf
    return map_hf_decoder_state_dict(sd, cfg, device, quantize)


# ---------------------------------------------------------------------------
# Serving wrapper
# ---------------------------------------------------------------------------


class DecoderLM:
    """Local decoder LLM: tokenizer + prefill/decode + sampling.

    Generation runs :func:`decode_chunk` — up to 16 decode steps with
    sampling and EOS masking on the device — with one host sync per chunk.
    Weights are a local checkpoint when :func:`load_hf_decoder_weights`
    finds one, else seeded.  ``quantize="int8"`` serves weight-only int8
    (built without a float copy of the whole model on the device); nothing
    quantizes unless asked.  Runs on ``cuda:0`` unless ``device`` says
    otherwise.
    """

    def __init__(
        self,
        model_name: str = "mistral-7b-instruct",
        seed: int = 0,
        max_cache: int = 1024,
        eos_id: int | None = 2,
        quantize: str | None = None,
        device=None,
    ):
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        self.device = resolve_device(device)
        self.config = decoder_config_for(model_name)
        self.model_name = model_name
        self.max_cache = min(max_cache, self.config.max_len)
        self.eos_id = eos_id
        self.tokenizer = load_tokenizer(model_name, self.config.vocab_size, self.config.max_len)
        tree = load_hf_decoder_weights(model_name, self.config, self.device, quantize)
        self.pretrained = tree is not None
        if tree is None:
            tree = init_decoder_params(self.config, seed, self.device, quantize)
        self.params = tree
        self.quantized = quantize == "int8"
        self._chunk_len = 16
        # self-speculative decoding: the int8 draft tree, built at first use,
        # and what its rounds accepted (active rows only)
        self._draft_tree = None
        self.speculative_stats = {"rounds": 0, "row_rounds": 0, "accepted": 0}

    def n_params(self) -> int:
        def count(node):
            if isinstance(node, dict):
                return sum(count(v) for v in node.values())
            return node.numel()

        return count(self.params)

    def generate_ids(
        self,
        prompt_ids: list[list[int]],
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        seed: int = 0,
        top_k: int | None = None,
        top_p: float | None = None,
        min_p: float | None = None,
        repetition_penalty: float | None = None,
    ) -> list[list[int]]:
        """Batched generation; returns the newly generated ids per row.

        ``top_k``/``top_p``/``min_p`` truncate the sampling distribution
        (only meaningful with ``temperature > 0``); ``repetition_penalty``
        (HF semantics) penalizes every token already in the prompt or
        generated so far.  Prompts longer than the cache budget keep their
        TAIL."""
        if repetition_penalty is not None and repetition_penalty <= 0:
            raise ValueError(f"repetition_penalty must be > 0, got {repetition_penalty}")
        prompt_ids, ids, lengths = self._prompt_batch(prompt_ids, max_new_tokens)
        B = len(prompt_ids)
        dev = self.device
        greedy = temperature <= 0.0
        temp = temperature if temperature > 0.0 else 1.0
        generator = torch.Generator(device=dev).manual_seed(seed)
        out: list[list[int]] = [[] for _ in range(B)]
        with torch.inference_mode():
            ids_t = torch.from_numpy(ids).to(dev)
            pos = torch.from_numpy(lengths).to(dev)  # next write position per row
            logits, kc, vc = prefill(self.params, ids_t, pos, self.config, self.max_cache)
            done = torch.zeros(B, dtype=torch.bool, device=dev)
            seen = None
            if repetition_penalty is not None:
                # HF counts the prompt too: mark every real prompt token
                seen = torch.zeros((B, self.config.vocab_size), dtype=torch.bool, device=dev)
                for i, p in enumerate(prompt_ids):
                    seen[i, torch.tensor(p, dtype=torch.int64, device=dev)] = True
            produced = 0
            while produced < max_new_tokens:
                remaining = max_new_tokens - produced
                # power-of-two step bucket covering `remaining`, capped
                K = min(self._chunk_len, 1 << (remaining - 1).bit_length())
                toks, valids, logits, kc, vc, pos, done, seen = decode_chunk(
                    self.params, kc, vc, logits, pos, done, generator, temp,
                    self.config, K, greedy, self.eos_id, top_k, top_p, min_p,
                    repetition_penalty, seen,
                )
                # one host sync per chunk
                htoks, hvalid = toks.cpu().numpy(), valids.cpu().numpy()
                take = min(K, remaining)
                for t in range(take):
                    for i in range(B):
                        if hvalid[t, i]:
                            out[i].append(int(htoks[t, i]))
                produced += take
                if bool(done.all()):
                    break
        return out

    def _prompt_batch(self, prompt_ids, max_new_tokens: int):
        """Prompts cut to the cache budget (their TAIL is kept), padded to a
        power-of-two bucket: ``(prompt_ids, ids [B, S], lengths [B])``."""
        if max_new_tokens >= self.max_cache:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} must be < max_cache={self.max_cache}"
            )
        limit = self.max_cache - max_new_tokens
        prompt_ids = [p[-limit:] if len(p) > limit else p for p in prompt_ids]
        lengths = np.array([max(len(p), 1) for p in prompt_ids], np.int64)
        S = _bucket_prompt_len(int(lengths.max()), self.max_cache)
        ids = np.zeros((len(prompt_ids), S), np.int64)
        for i, p in enumerate(prompt_ids):
            ids[i, : len(p)] = p
        return prompt_ids, ids, lengths

    def generate_ids_speculative(
        self,
        prompt_ids: list[list[int]],
        max_new_tokens: int = 64,
        n_draft: int = 8,
    ) -> list[list[int]]:
        """Greedy generation by SELF-SPECULATIVE decoding.

        Each round drafts ``n_draft`` tokens with the int8-quantized tree
        (built at first use), verifies them with the float tree in one
        :func:`verify_block` sweep and accepts the matching prefix
        (:func:`speculative_decode_chunk`).  The emitted chain is the one
        ``generate_ids(temperature=0)`` gives.  One host sync per round;
        ``speculative_stats`` adds up the rounds, the active row-rounds and
        the tokens they accepted.  A quantized target raises ``ValueError``.
        """
        if self.quantized:
            raise ValueError(
                "speculative decoding verifies with the float tree: "
                "construct DecoderLM without quantize (the int8 draft is "
                "built internally)"
            )
        if not 1 <= n_draft <= self.max_cache:
            raise ValueError(f"n_draft={n_draft} must be in [1, max_cache={self.max_cache}]")
        prompt_ids, ids, lengths = self._prompt_batch(prompt_ids, max_new_tokens)
        if self._draft_tree is None:
            self._draft_tree = quantize_decoder_tree(self.params)
        B = len(prompt_ids)
        dev = self.device
        out: list[list[int]] = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        stats = self.speculative_stats
        with torch.inference_mode():
            pos = torch.from_numpy(lengths).to(dev)
            logits, kc, vc = prefill(self.params, torch.from_numpy(ids).to(dev), pos,
                                     self.config, self.max_cache)
            # the draft's own cache, refreshed from the target's each round
            draft_cache = (torch.empty_like(kc), torch.empty_like(vc))
            while not done.all():
                toks, n_match, logits, kc, vc, pos = speculative_decode_chunk(
                    self.params, self._draft_tree, kc, vc, logits, pos, self.config,
                    n_draft, done=torch.from_numpy(done).to(dev), draft_cache=draft_cache,
                )
                htoks, hn = toks.cpu().numpy(), n_match.cpu().numpy()  # one host sync per round
                stats["rounds"] += 1
                stats["row_rounds"] += int((~done).sum())
                stats["accepted"] += int(hn.sum())
                for i in range(B):
                    if done[i]:
                        continue
                    for t in range(int(hn[i])):
                        tok = int(htoks[i, t])
                        if self.eos_id is not None and tok == self.eos_id:
                            done[i] = True
                            break
                        out[i].append(tok)
                        if len(out[i]) >= max_new_tokens:
                            done[i] = True
                            break
        return out

    def generate(
        self,
        prompt: str,
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        seed: int = 0,
        top_k: int | None = None,
        top_p: float | None = None,
        min_p: float | None = None,
        repetition_penalty: float | None = None,
    ) -> str:
        new_ids = self.generate_ids(
            [self._encode_prompt(prompt)], max_new_tokens, temperature, seed,
            top_k=top_k, top_p=top_p, min_p=min_p,
            repetition_penalty=repetition_penalty,
        )[0]
        return self.tokenizer.decode(new_ids)

    def _encode_prompt(self, prompt: str) -> list[int]:
        """Tokenize at the MODEL limit, not the cache limit: ``generate_ids``
        keeps the prompt's tail against the cache budget itself."""
        return self.tokenizer.encode(prompt, max_length=self.config.max_len)

    def generate_many(
        self,
        prompts: list[str],
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        seed: int = 0,
        top_k: int | None = None,
        top_p: float | None = None,
        min_p: float | None = None,
        repetition_penalty: float | None = None,
    ) -> list[str]:
        """One padded ragged batch through prefill+decode for all prompts."""
        outs = self.generate_ids(
            [self._encode_prompt(p) for p in prompts], max_new_tokens, temperature,
            seed, top_k=top_k, top_p=top_p, min_p=min_p,
            repetition_penalty=repetition_penalty,
        )
        return [self.tokenizer.decode(o) for o in outs]


@functools.lru_cache(maxsize=4)
def shared_decoder(
    model_name: str = "mistral-7b-instruct",
    max_cache: int = 1024,
    quantize: str | None = None,
    device=None,
) -> DecoderLM:
    return DecoderLM(model_name, max_cache=max_cache, quantize=quantize, device=device)

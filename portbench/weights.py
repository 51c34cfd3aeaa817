"""Seeded weights, made on the device in a few large calls, in the type
they are served in (bfloat16), and handed to the program and to the
reference alike."""

from __future__ import annotations

import math

import torch


def _gen(seed: int, device, salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + salt) % (2**63))


def bert_tree(cfg: dict, seed: int, device) -> dict:
    """A BERT encoder's weights in the Flax module layout the program's
    ``set_params`` takes: one normal draw for the whole tree, cut into
    leaves and scaled (embeddings 1/√H, kernels 1/√fan-in, biases 0.02,
    LayerNorm scales 1 ± 0.05), rounded to bfloat16."""
    H, F = cfg["hidden_size"], cfg["intermediate_size"]
    heads = cfg["num_attention_heads"]
    hd = H // heads
    V, P, layers = cfg["vocab_size"], cfg["max_position_embeddings"], cfg["num_hidden_layers"]
    spec: list[tuple[tuple, tuple, float, float]] = []  # (path, shape, std, mean)

    def ln(path):
        spec.append((path + ("scale",), (H,), 0.05, 1.0))
        spec.append((path + ("bias",), (H,), 0.02, 0.0))

    def dense(path, shape, fan_in, bias_shape):
        spec.append((path + ("kernel",), shape, 1 / math.sqrt(fan_in), 0.0))
        spec.append((path + ("bias",), bias_shape, 0.02, 0.0))

    spec.append((("Embed_0", "embedding"), (V, H), 1 / math.sqrt(H), 0.0))
    spec.append((("Embed_1", "embedding"), (P, H), 1 / math.sqrt(H), 0.0))
    ln(("LayerNorm_0",))
    for i in range(layers):
        b = (f"TransformerBlock_{i}",)
        att = b + ("MultiHeadDotProductAttention_0",)
        for name in ("query", "key", "value"):
            dense(att + (name,), (H, heads, hd), H, (heads, hd))
        dense(att + ("out",), (heads, hd, H), H, (H,))
        ln(b + ("LayerNorm_0",))
        dense(b + ("Dense_0",), (H, F), H, (F,))
        dense(b + ("Dense_1",), (F, H), F, (H,))
        ln(b + ("LayerNorm_1",))
    total = sum(math.prod(shape) for _p, shape, _s, _m in spec)
    flat = torch.randn(total, generator=_gen(seed, device, 1), device=device)
    enc: dict = {}
    at = 0
    for path, shape, std, mean in spec:
        n = math.prod(shape)
        leaf = (flat[at : at + n] * std + mean).reshape(shape).to(torch.bfloat16)
        at += n
        node = enc
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return {"params": {"Encoder_0": enc}}


def to_numpy_f32(tree):
    """The same tree as nested dicts of float32 numpy arrays (exact: every
    value is a bfloat16)."""
    if isinstance(tree, dict):
        return {k: to_numpy_f32(v) for k, v in tree.items()}
    return tree.float().cpu().numpy()


def mistral_tree(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """A dense decoder's weights, layers stacked on a leading axis and
    products as ``x @ w``: one normal draw a stacked leaf, scaled by
    1/√fan-in (norm scales 1 ± 0.05)."""
    H, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    NH, KH, L = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["num_hidden_layers"]
    D = H // NH
    gen = _gen(seed, device, 2)

    def normal(shape, std, mean=0.0):
        t = torch.empty(shape, dtype=dtype, device=device)
        t.normal_(mean, std, generator=gen)
        return t

    layers = {
        "ln0": normal((L, H), 0.05, 1.0),
        "ln1": normal((L, H), 0.05, 1.0),
        "wq": normal((L, H, NH * D), 1 / math.sqrt(H)),
        "wk": normal((L, H, KH * D), 1 / math.sqrt(H)),
        "wv": normal((L, H, KH * D), 1 / math.sqrt(H)),
        "wo": normal((L, NH * D, H), 1 / math.sqrt(NH * D)),
        "wg": normal((L, H, F), 1 / math.sqrt(H)),
        "wu": normal((L, H, F), 1 / math.sqrt(H)),
        "wd": normal((L, F, H), 1 / math.sqrt(F)),
    }
    return {
        "embed": normal((V, H), 1 / math.sqrt(H)),
        "final_norm": normal((H,), 0.05, 1.0),
        "lm_head": normal((H, V), 1 / math.sqrt(H)),
        "layers": layers,
    }

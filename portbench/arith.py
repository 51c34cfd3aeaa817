"""The yardstick's arithmetic: peaks of the card, and the operations and
bytes of each piece of work, counted from shapes.

Every count is of the work the algorithm needs, whatever implements it:
padded rows and the pages of idle slots are not counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense (no sparsity), at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2
F32_BYTES = 4


def bert_sequence_flops(length: int, hidden: int, layers: int, intermediate: int) -> float:
    """Model FLOPs of one BERT forward over ``length`` real tokens: per
    layer the QKV and output projections (8·L·H²), the feed-forward
    (4·L·H·F) and the two attention products (4·L²·H)."""
    L = length
    return layers * (L * (8 * hidden * hidden + 4 * hidden * intermediate) + 4 * L * L * hidden)


def encoder_attention_flops(B: int, S: int, H: int) -> float:
    """QKᵀ and PV of one bidirectional attention call on ``[B, S, H]``."""
    return 4.0 * B * S * S * H


def encoder_attention_bytes(B: int, S: int, H: int) -> float:
    """q, k, v (bf16) and the f32 key bias read once, the bf16 output
    written once."""
    return (3 + 1) * B * S * H * BF16_BYTES + B * S * F32_BYTES


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def decoder_matmul_params(cfg: dict) -> int:
    """Weights one token multiplies by in one layer of a dense decoder."""
    H, NH, KH = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = H // NH
    return H * NH * D + 2 * H * KH * D + NH * D * H + 3 * H * cfg["intermediate_size"]


def decoder_token_flops(cfg: dict, context: int, logits: bool) -> float:
    """FLOPs of one token at position ``context - 1`` through every layer
    (attention over ``context`` keys, cut to the sliding window), and the
    output head when its logits are computed."""
    H, NH = cfg["hidden_size"], cfg["num_attention_heads"]
    D = H // NH
    window = cfg.get("sliding_window") or context
    per_layer = 2 * decoder_matmul_params(cfg) + 4 * min(context, window) * NH * D
    return cfg["num_hidden_layers"] * per_layer + (2 * H * cfg["vocab_size"] if logits else 0)


def decode_attention_bytes(cfg: dict, live_tokens: int, rows: int) -> float:
    """One decode step's paged attention over every layer: the K and V of
    ``live_tokens`` cached positions (whole live pages) read once, and each
    of ``rows`` rows' query read and output written once."""
    H, NH, KH = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = H // NH
    per_layer = 2 * live_tokens * KH * D * BF16_BYTES + 2 * rows * NH * D * BF16_BYTES
    return cfg["num_hidden_layers"] * per_layer


def decode_attention_flops(cfg: dict, contexts: list[int]) -> float:
    """QKᵀ and PV of one decode step's rows over their contexts."""
    H, NH = cfg["hidden_size"], cfg["num_attention_heads"]
    D = H // NH
    window = cfg.get("sliding_window")
    return cfg["num_hidden_layers"] * sum(4 * (min(c, window) if window else c) * NH * D for c in contexts)

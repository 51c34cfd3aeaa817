"""Mistral decoder forward in float32, teacher-forced over whole sequences.

The weights are the harness's seeded tree (``portbench/weights.py``),
layers stacked on a leading axis, products as ``x @ w``: ``embed``
``[V, H]``, ``lm_head`` ``[H, V]``, ``final_norm``, and per layer
``ln0``, ``ln1`` (RMSNorm scales), ``wq``, ``wk``, ``wv``, ``wo``,
``wg``, ``wu``, ``wd``.  Pre-norm blocks: RMSNorm, rotary embedding on the
two halves of each head, grouped-query causal attention inside the
sliding window, residual, RMSNorm, SwiGLU, residual; final RMSNorm and the
output head.  Each layer's weights are read in float32 as it runs.
"""

from __future__ import annotations

import math

import torch


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, pos, theta):
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d))
    ang = (pos[:, :, None].double() * inv).float()[:, :, None, :]  # [B, S, 1, d/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def logits_at(tree, cfg: dict, seqs: list[list[int]], positions: list[list[int]], device) -> list[torch.Tensor]:
    """Float32 logits ``[len(positions[i]), V]`` of each sequence at the
    given positions (the logits there predict the token after each)."""
    H, NH, KH = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D, eps, theta = H // NH, cfg["rms_norm_eps"], cfg["rope_theta"]
    window = cfg.get("sliding_window")
    L = cfg["num_hidden_layers"]
    B, S = len(seqs), max(len(s) for s in seqs)
    ids = torch.zeros((B, S), dtype=torch.long, device=device)
    for b, s in enumerate(seqs):
        ids[b, : len(s)] = torch.tensor(s, device=device)
    pos = torch.arange(S, device=device)[None].expand(B, S)
    allowed = pos[0][None, :] <= pos[0][:, None]  # [S(q), S(k)] causal
    if window is not None:
        allowed = allowed & (pos[0][None, :] > pos[0][:, None] - window)
    bias = torch.where(allowed, 0.0, float("-inf"))[None, None]
    lay = tree["layers"]
    with torch.no_grad():
        x = tree["embed"][ids].float()
        for i in range(L):
            w = {k: v[i].float() for k, v in lay.items()}
            h = _rms(x, w["ln0"], eps)
            q = _rope((h @ w["wq"]).reshape(B, S, NH, D), pos, theta)
            k = _rope((h @ w["wk"]).reshape(B, S, KH, D), pos, theta)
            v = (h @ w["wv"]).reshape(B, S, KH, D)
            k = k.repeat_interleave(NH // KH, dim=2)
            v = v.repeat_interleave(NH // KH, dim=2)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D) + bias
            ctx = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v).reshape(B, S, NH * D)
            x = x + ctx @ w["wo"]
            h = _rms(x, w["ln1"], eps)
            x = x + (torch.nn.functional.silu(h @ w["wg"]) * (h @ w["wu"])) @ w["wd"]
            del w, q, k, v, scores, ctx, h
        x = _rms(x, tree["final_norm"].float(), eps)
        head = tree["lm_head"].float()
        return [x[b, torch.tensor(p, device=device, dtype=torch.long)] @ head for b, p in enumerate(positions)]

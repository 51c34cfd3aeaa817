"""BERT sentence encoder in float32: the architecture the port serves.

The weights are the harness's seeded tree (``portbench/weights.py``), in
the Flax module layout: ``Encoder_0`` with ``Embed_0`` (words),
``Embed_1`` (positions), ``LayerNorm_0`` and ``TransformerBlock_<i>``.
Each block is post-norm: self-attention, residual, LayerNorm, a GELU
feed-forward, residual, LayerNorm.  The port's choices, noted as
departures from the published BERT: no token-type embedding, LayerNorm
eps 1e-6, the tanh form of GELU, a -1e9 key bias for padding.  Pooling is
the CLS row or the masked mean, then unit length.
"""

from __future__ import annotations

import math

import torch

LN_EPS = 1e-6
PAD_BIAS = -1e9


def _ln(x, p):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], LN_EPS)


def _f32(tree, device):
    if isinstance(tree, dict):
        return {k: _f32(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device=device, dtype=torch.float32)


def forward(tree, ids: torch.Tensor, mask: torch.Tensor, heads: int, pooling: str) -> torch.Tensor:
    """Unit sentence embeddings ``[B, H]`` of padded ``ids [B, S]`` with
    ``mask [B, S]`` (1 on real tokens)."""
    enc = tree["params"]["Encoder_0"]
    B, S = ids.shape
    x = enc["Embed_0"]["embedding"][ids] + enc["Embed_1"]["embedding"][:S][None]
    x = _ln(x, enc["LayerNorm_0"])
    H = x.shape[-1]
    hd = H // heads
    bias = torch.where(mask > 0, 0.0, PAD_BIAS).to(x.dtype)[:, None, None, :]
    i = 0
    while f"TransformerBlock_{i}" in enc:
        blk = enc[f"TransformerBlock_{i}"]
        att = blk["MultiHeadDotProductAttention_0"]

        def heads_of(name):
            w = att[name]["kernel"].reshape(H, H)
            return (x @ w + att[name]["bias"].reshape(H)).reshape(B, S, heads, hd).transpose(1, 2)

        q, k, v = heads_of("query"), heads_of("key"), heads_of("value")
        scores = q @ k.transpose(-1, -2) / math.sqrt(hd) + bias
        ctx = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, S, H)
        x = _ln(x + ctx @ att["out"]["kernel"].reshape(H, H) + att["out"]["bias"], blk["LayerNorm_0"])
        h = torch.nn.functional.gelu(x @ blk["Dense_0"]["kernel"] + blk["Dense_0"]["bias"], approximate="tanh")
        x = _ln(x + h @ blk["Dense_1"]["kernel"] + blk["Dense_1"]["bias"], blk["LayerNorm_1"])
        i += 1
    if pooling == "cls":
        pooled = x[:, 0]
    else:
        m = mask[:, :, None].to(x.dtype)
        pooled = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
    return pooled / (pooled.norm(dim=1, keepdim=True) + 1e-12)


def embed(tree, id_lists: list[list[int]], heads: int, pooling: str, device, block: int = 32) -> torch.Tensor:
    """Embeddings ``[N, H]`` of ragged id lists, in blocks of ``block``
    rows padded to the longest of the block; the weights in float32."""
    w = _f32(tree, device)
    out = []
    for at in range(0, len(id_lists), block):
        rows = id_lists[at : at + block]
        S = max(len(r) for r in rows)
        ids = torch.zeros((len(rows), S), dtype=torch.long, device=device)
        mask = torch.zeros((len(rows), S), dtype=torch.long, device=device)
        for r, row in enumerate(rows):
            ids[r, : len(row)] = torch.tensor(row, device=device)
            mask[r, : len(row)] = 1
        with torch.no_grad():
            out.append(forward(w, ids, mask, heads, pooling))
    return torch.cat(out) if out else torch.zeros((0, 0), device=device)

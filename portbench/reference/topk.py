"""Exact cosine scores, and a cosine top-k one precision below the index's
bfloat16, as the control of the retrieval check."""

from __future__ import annotations

import torch


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    x = x.double()
    return x / x.norm(dim=1, keepdim=True).clamp(min=1e-12)


def cosine_scores(queries: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """Exact cosine of each query with each document, in float64."""
    return unit_rows(queries) @ unit_rows(docs).T


def fp8_cosine_topk(queries: torch.Tensor, docs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k with unit rows held in float8 (e4m3), products summed in
    float32 and scores given back in bfloat16: an index one precision
    below a bfloat16 one."""
    f8 = torch.float8_e4m3fn
    q = unit_rows(queries).float().to(f8).float()
    d = unit_rows(docs).float().to(f8).float()
    scores = (q @ d.T).to(torch.bfloat16).float()
    return torch.topk(scores, min(k, docs.shape[0]), dim=1)

"""Mixture-of-Experts feed-forward layer (Mixtral-style sparse MoE).

Counterpart of ``pathway_tpu/parallel/moe.py``: the same config, the same
GShard formulation and the same numbers.  Tokens route to their top-k
experts through dense one-hot DISPATCH and COMBINE tensors:

* **Static capacity.**  Each expert takes a fixed ``capacity`` of token
  slots per group; tokens past it are dropped from that expert (their
  residual stream passes through).  The serving paths ask for
  ``full_capacity``: ``C = Tg`` slots per group, which no expert can
  exceed, so no token is ever dropped.
* **Rank-major slot order** (GShard priority): every token's first choice
  is placed before any token's second choice, so an overflow drops
  second opinions first.
* **Renormalised top-k gates**: with identical experts the layer equals
  the dense SwiGLU FFN.
* **Switch load-balance aux loss** ``E * Σ_e f_e · P_e`` over top-1
  assignments, returned beside the output.
* **Router in f32**, whatever the activation dtype.

Expert weights are stacked on a leading ``[E, ...]`` axis, as float
tensors or as weight-only int8 pairs ``{"q": int8, "s": f32}`` with
per-output-channel scales (see ``models/decoder.py``).  Every function
works on the device of its inputs, and the float path is differentiable
(the gradient flows through the combine weights and the aux loss):
:func:`make_moe_train_step` trains the layer on one device.  The
expert-parallel mesh (``ep_param_specs``, ``make_ep_mesh``) waits for the
multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from pathway_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    hidden: int
    experts: int
    intermediate: int
    top_k: int = 2
    capacity_factor: float = 1.25
    # GShard group axis: tokens are chunked into groups of at most this
    # many and dispatched group-locally, so the [G, Tg, E, C] dispatch
    # tensor stays linear in the token count.  0 = one global group.
    group_size: int = 4096
    # full_capacity makes the dispatch tensors [Tg, E, Tg] per group,
    # quadratic in the group size: serving uses this smaller group and
    # runs the groups one at a time.  0 falls back to group_size.
    serving_group_size: int = 1024
    dtype: Any = torch.float32

    def capacity(self, n_tokens: int) -> int:
        """Static per-expert token slots for an ``n_tokens`` group."""
        return max(
            self.top_k,
            int(math.ceil(self.capacity_factor * self.top_k * n_tokens / self.experts)),
        )


def init_moe_params(cfg: MoEConfig, seed: int = 0, device=None) -> dict:
    """Scaled-normal init (normal / sqrt(fan_in)) from one
    ``torch.Generator`` on ``device`` (``cuda:0`` unless given): an f32
    router ``[H, E]`` and expert weights stacked ``[E, ...]`` in
    ``cfg.dtype``.  The JAX tree's shapes and scales; the bits differ from
    the JAX package's for the same seed."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    E, H, F_ = cfg.experts, cfg.hidden, cfg.intermediate

    def normal(shape, fan_in, dtype=cfg.dtype):
        w = torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)
        return w.to(dtype)

    return {
        "router": normal((H, E), H, torch.float32),
        "wg": normal((E, H, F_), H),
        "wu": normal((E, H, F_), H),
        "wd": normal((E, F_, H), F_),
    }


def _one_hot(idx, n: int):
    """f32 one-hot of integer ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row, as ``jax.nn.one_hot`` does (and no host
    sync, unlike ``F.one_hot`` on a CUDA tensor)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _routing(router_logits, cfg: MoEConfig, capacity: int, valid=None):
    """Top-k dispatch/combine tensors from f32 router logits ``[..., T, E]``
    (any leading group axes).

    Returns ``(dispatch [..., T, E, C] f32 0/1, combine [..., T, E, C]
    f32, aux [...])``.  Buffer slots are assigned rank-major, token-major
    within a rank; ``valid [..., T]`` masks padding tokens out of the
    dispatch, the capacity accounting and the aux statistics.  The top-k
    is a stable descending sort, so tied probabilities pick the lower
    expert index first, as ``lax.top_k`` does.
    """
    lead = router_logits.shape[:-2]
    T, E = router_logits.shape[-2:]
    K = cfg.top_k
    probs = torch.softmax(router_logits.float(), dim=-1)  # [..., T, E]
    gate_k, idx_k = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_k, idx_k = gate_k[..., :K], idx_k[..., :K]  # [..., T, K]
    gate_k = gate_k / gate_k.sum(-1, keepdim=True).clamp_min(1e-9)

    sel = _one_hot(idx_k.transpose(-1, -2), E)  # [..., K, T, E]
    if valid is not None:
        sel = sel * valid.float()[..., None, :, None]
    flat = sel.reshape(*lead, K * T, E)
    pos = flat.cumsum(dim=-2) - flat  # buffer slot per (rank, token)
    keep = (pos < capacity).float() * flat  # dropped past capacity
    disp_flat = keep[..., None] * _one_hot(pos.long(), capacity)  # [..., K*T, E, C]
    gates_flat = gate_k.transpose(-1, -2).reshape(*lead, K * T)
    dispatch = disp_flat.reshape(*lead, K, T, E, capacity).sum(-4)
    combine = (disp_flat * gates_flat[..., None, None]).reshape(*lead, K, T, E, capacity).sum(-4)

    # Switch load-balance loss over top-1 assignment (valid tokens only)
    top1 = _one_hot(idx_k[..., 0], E)  # [..., T, E]
    if valid is not None:
        v = valid.float()[..., None]
        n = v.sum(dim=(-2, -1)).clamp_min(1.0)[..., None]
        frac_tokens = (top1 * v).sum(-2) / n
        frac_probs = (probs * v).sum(-2) / n
    else:
        frac_tokens = top1.mean(-2)
        frac_probs = probs.mean(-2)
    aux = E * (frac_tokens * frac_probs).sum(-1)
    return dispatch, combine, aux


def _qeinsum(spec: str, x, w):
    """``einsum`` over a float weight or an int8 weight-only pair
    (``{"q", "s"}``, per-output-channel scales over the contraction axis):
    the codes are converted to the activation dtype for the product and the
    scale multiplies the OUTPUT, in the JAX package's order.  The converted
    codes are a temporary of this call, never kept."""
    if isinstance(w, dict):
        out = torch.einsum(spec, x, w["q"].to(x.dtype))
        # s keeps a singleton on the contraction axis, which lines up
        # against the output's slot axis under broadcasting
        return out * w["s"].to(x.dtype)[None]
    return torch.einsum(spec, x, w)


def _groups_ffn(params, router_logits, valid, xg, cfg: MoEConfig, capacity: int):
    """Dispatch → expert SwiGLU → combine over groups ``[G, Tg, ...]``;
    returns ``(y [G, Tg, H], aux [G])``."""
    dispatch, combine, aux_g = _routing(router_logits, cfg, capacity, valid)
    expert_in = torch.einsum("gtec,gth->gech", dispatch.to(cfg.dtype), xg.to(cfg.dtype))
    h = F.silu(_qeinsum("gech,ehf->gecf", expert_in, params["wg"]))
    h = h * _qeinsum("gech,ehf->gecf", expert_in, params["wu"])
    expert_out = _qeinsum("gecf,efh->gech", h, params["wd"])
    y = torch.einsum("gtec,gech->gth", combine.to(cfg.dtype), expert_out)
    return y, aux_g


def moe_ffn(params, x, cfg: MoEConfig, *, full_capacity: bool = False):
    """MoE feed-forward over tokens ``x [..., H]`` → ``(y [..., H], aux)``.

    Tokens beyond the group size are chunked into GShard groups and
    dispatched group-locally (a ragged tail group is padded and masked).
    ``full_capacity=True`` gives every token guaranteed slots (``C = Tg``
    per group); the serving paths use it, with the smaller
    ``cfg.serving_group_size``.  Otherwise ``C = cfg.capacity(Tg)``.  The
    groups run one at a time, so only one group's dispatch tensors exist
    at once (the JAX package maps the serving groups and vectorizes the
    others; the numbers are the same).  ``aux`` is the groups'
    load-balance loss, weighted by their real tokens.
    """
    orig_shape = x.shape
    H = orig_shape[-1]
    xt = x.reshape(-1, H)
    T = xt.shape[0]
    group_size = cfg.group_size
    if full_capacity and cfg.serving_group_size:
        group_size = min(group_size, cfg.serving_group_size) if group_size else cfg.serving_group_size
    if not group_size or T <= group_size:
        G, Tg = 1, T
    else:
        G, Tg = -(-T // group_size), group_size
    pad = G * Tg - T
    if pad:
        xt = torch.cat([xt, xt.new_zeros((pad, H))])
    C = Tg if full_capacity else cfg.capacity(Tg)
    xg = xt.reshape(G, Tg, H)
    router_logits = xg.float() @ params["router"]  # [G, Tg, E]
    valid = (torch.arange(G * Tg, device=x.device) < T).reshape(G, Tg)

    outs = [
        _groups_ffn(params, router_logits[g : g + 1], valid[g : g + 1], xg[g : g + 1], cfg, C)
        for g in range(G)
    ]
    y_g = torch.cat([y for y, _ in outs])
    aux_g = torch.cat([a for _, a in outs])

    w = valid.float().sum(dim=1)
    aux = (aux_g * w).sum() / w.sum().clamp_min(1.0)
    y = y_g.reshape(G * Tg, H)[:T]
    return y.reshape(orig_shape).to(x.dtype), aux


def make_moe_train_step(cfg: MoEConfig, optimizer, *, device=None,
                        aux_weight: float = 0.01) -> tuple[Callable, Callable]:
    """Training of the MoE layer on one device (``cuda:0`` unless given):
    the JAX package's denoising regression (fit the layer to a fixed
    target map, the mean squared error plus ``aux_weight`` times the
    load-balance loss), through routing, capacity-dropping dispatch and
    combine.  ``optimizer`` is a ``torch.optim`` factory (see
    ``parallel/train.py``).

    Returns ``(init_fn, step_fn)``: ``init_fn(seed=0) -> (params,
    opt_state)`` draws :func:`init_moe_params` with every leaf trainable;
    ``step_fn(params, opt_state, x, target) -> (params, opt_state, loss)``
    updates the params in place.  An int8 tree raises ``ValueError``: it is
    for serving only.  The expert-parallel form over a mesh waits for the
    multi-GPU slice."""
    from pathway_tpu_torch.parallel.train import TrainState, apply_step, require_float, train_state

    device = resolve_device(device)

    def init_fn(seed: int = 0):
        state = train_state(init_moe_params(cfg, seed, device=device), optimizer)
        return state.params, state.opt_state

    def step_fn(params, opt_state, x, target):
        require_float(params)
        x, target = torch.as_tensor(x, device=device), torch.as_tensor(target, device=device)
        y, aux = moe_ffn(params, x, cfg)
        loss = (y.float() - target.float()).square().mean() + aux_weight * aux
        state, loss = apply_step(TrainState(params, opt_state), loss)
        return state.params, state.opt_state, loss

    return init_fn, step_fn

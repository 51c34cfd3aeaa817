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
:func:`make_moe_train_step` trains the layer on one device or on a mesh.

**Expert parallelism.**  On a ``("data", "expert")`` mesh
(:func:`make_ep_mesh`) each rank holds ``E / |expert|`` experts
(:func:`ep_param_specs`) and its rows of the token batch.  The JAX
program has global semantics: routing and capacity slots are a cumulative
sum over each group of the GLOBAL token order.  So a rank gathers the
tokens over ``data``, routes every token to every expert, runs its own
experts on their slots, sums the partial outputs over ``expert``, and
keeps its own rows (:class:`ExpertShard`).  Every rank's answer equals the
unsharded layer's.  The ``all_to_all`` form that XLA lowers the JAX
einsums to moves fewer bytes; it is a later speed change.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.parallel.collectives import copy_to, gather_rows, own_rows, reduce_from


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


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """A rank's share of an expert-parallel MoE layer: its weights are
    experts ``[first, first + count)`` of the layer, their partial outputs
    are summed over ``group`` (``None``: the rank holds every expert).
    With ``data_group`` the rank's tokens are its rows of the batch,
    gathered over that group so that routing and capacity follow the
    global token order, and the rank keeps its rows of the output."""

    group: Any
    first: int
    count: int
    data_group: Any = None

    def enter(self, x):
        """A replicated tensor entering the rank's experts (Megatron's
        copy: the experts' partial gradients summed backward)."""
        return x if self.group is None else copy_to(x, self.group)

    def reduce(self, y):
        return y if self.group is None else reduce_from(y, self.group)


def _groups_ffn(params, router_logits, valid, xg, cfg: MoEConfig, capacity: int, shard=None):
    """Dispatch → expert SwiGLU → combine over groups ``[G, Tg, ...]``;
    returns ``(y [G, Tg, H], aux [G])``.  With ``shard`` every token is
    routed over all experts and only the shard's run, their partial
    outputs summed over its group."""
    dispatch, combine, aux_g = _routing(router_logits, cfg, capacity, valid)
    if shard is not None:
        own = slice(shard.first, shard.first + shard.count)
        dispatch, combine, xg = dispatch[:, :, own], shard.enter(combine)[:, :, own], shard.enter(xg)
    expert_in = torch.einsum("gtec,gth->gech", dispatch.to(cfg.dtype), xg.to(cfg.dtype))
    h = F.silu(_qeinsum("gech,ehf->gecf", expert_in, params["wg"]))
    h = h * _qeinsum("gech,ehf->gecf", expert_in, params["wu"])
    expert_out = _qeinsum("gecf,efh->gech", h, params["wd"])
    y = torch.einsum("gtec,gech->gth", combine.to(cfg.dtype), expert_out)
    return (y if shard is None else shard.reduce(y)), aux_g


def ep_param_specs(axis: str = "expert") -> dict:
    """Expert-parallel specs (``PartitionSpec`` tuples, see
    ``parallel/sharding.py``): each rank owns ``E / |axis|`` experts' FFN
    weights; the router (tiny) is replicated."""
    return {"router": (None, None), "wg": (axis, None, None), "wu": (axis, None, None), "wd": (axis, None, None)}


def make_ep_mesh(n_devices: int, expert_parallel: int | None = None, *, device=None) -> DeviceMesh:
    """A ``("data", "expert")`` mesh over the process group's world with
    ``expert_parallel`` ranks on the expert axis (default: all of them).
    ``n_devices`` other than the world's size, or an expert axis that does
    not divide it, raises."""
    from pathway_tpu_torch.parallel.mesh import world_mesh, world_size

    n = world_size(n_devices, device=device)
    ep = expert_parallel or n
    if n % ep:
        raise ValueError(f"{n} devices do not split into expert groups of {ep}")
    return world_mesh((n // ep, ep), ("data", "expert"), device=device)


def expert_shard(params, mesh: DeviceMesh) -> tuple[dict, ExpertShard]:
    """The rank's local weights of a mesh-placed layer and its
    :class:`ExpertShard`: the expert axis is the mesh dim that splits
    ``wg``'s experts (none when they are replicated), the data axis the
    mesh dim named ``"data"`` if there is one."""
    local = {k: (v.to_local() if isinstance(v, DTensor) else v) for k, v in params.items()}
    names = mesh.mesh_dim_names
    group, first, count = None, 0, local["wg"].shape[0]
    wg = params["wg"]
    if isinstance(wg, DTensor):
        for dim, p in enumerate(wg.placements):
            if p.is_shard(0):
                group, first = mesh.get_group(names[dim]), mesh.get_local_rank(names[dim]) * count
    data_group = mesh.get_group("data") if "data" in names else None
    return local, ExpertShard(group, first, count, data_group)


def moe_ffn(params, x, cfg: MoEConfig, mesh: DeviceMesh | None = None, *, full_capacity: bool = False,
            shard: ExpertShard | None = None):
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

    With ``mesh`` (an :func:`make_ep_mesh` mesh) ``params`` is placed by
    :func:`ep_param_specs` and ``x`` holds this rank's rows of the tokens
    (a tensor, or a DTensor split over ``data``); ``y`` is the rank's rows
    of the unsharded layer's output and ``aux`` the unsharded layer's.
    ``shard`` is the same share given directly (the tensor-parallel
    decoder's experts over ``model``), with ``params`` the local weights.
    """
    if mesh is not None:
        params, shard = expert_shard(params, mesh)
    if isinstance(x, DTensor):
        x = x.to_local()
    orig_shape = x.shape
    H = orig_shape[-1]
    xt = x.reshape(-1, H)
    if shard is not None and shard.data_group is not None:
        xt = gather_rows(xt, shard.data_group)
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
        _groups_ffn(params, router_logits[g : g + 1], valid[g : g + 1], xg[g : g + 1], cfg, C, shard)
        for g in range(G)
    ]
    y_g = torch.cat([y for y, _ in outs])
    aux_g = torch.cat([a for _, a in outs])

    w = valid.float().sum(dim=1)
    aux = (aux_g * w).sum() / w.sum().clamp_min(1.0)
    y = y_g.reshape(G * Tg, H)[:T]
    if shard is not None and shard.data_group is not None:
        y = own_rows(y, shard.data_group)
    return y.reshape(orig_shape).to(x.dtype), aux


def make_moe_train_step(cfg: MoEConfig, optimizer, *, device=None, mesh: DeviceMesh | None = None,
                        aux_weight: float = 0.01) -> tuple[Callable, Callable]:
    """Training of the MoE layer on one device (``cuda:0`` unless given) or
    expert-parallel on ``mesh`` (:func:`make_ep_mesh`; one or the other):
    the JAX package's denoising regression (fit the layer to a fixed
    target map, the mean squared error plus ``aux_weight`` times the
    load-balance loss), through routing, capacity-dropping dispatch and
    combine.  ``optimizer`` is a ``torch.optim`` factory (see
    ``parallel/train.py``).

    Returns ``(init_fn, step_fn)``: ``init_fn(seed=0) -> (params,
    opt_state)`` draws :func:`init_moe_params` (on a mesh, on every rank,
    placed by :func:`ep_param_specs`) with every leaf trainable;
    ``step_fn(params, opt_state, x, target) -> (params, opt_state, loss)``
    updates the params in place.  ``x`` and ``target`` are the whole token
    batch (on a mesh, on every rank); each rank's loss is its rows' share
    of the squared error plus ``1 / |data|`` of the aux loss, and the
    gradients and the loss are summed over ``data``: the step equals the
    unsharded one.  An int8 tree raises ``ValueError``: it is for serving
    only."""
    from pathway_tpu_torch.parallel.sharding import place_tree
    from pathway_tpu_torch.parallel.train import TrainState, apply_step, data_rows, require_float, step_target, train_state

    device, data_group, n_data = step_target(device, mesh)

    def init_fn(seed: int = 0):
        params = init_moe_params(cfg, seed, device=device)
        if mesh is not None:
            params = place_tree(params, mesh, ep_param_specs())
        state = train_state(params, optimizer)
        return state.params, state.opt_state

    def step_fn(params, opt_state, x, target):
        require_float(params)
        n = torch.as_tensor(target).numel()
        x, target = data_rows(x, device, data_group), data_rows(target, device, data_group)
        y, aux = moe_ffn(params, x, cfg, mesh)
        loss = (y.float() - target.float()).square().sum() / n + aux_weight * aux / n_data
        state, loss = apply_step(TrainState(params, opt_state), loss, data_group=data_group)
        return state.params, state.opt_state, loss

    return init_fn, step_fn

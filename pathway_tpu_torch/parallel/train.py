"""Training on one device or on a mesh: the contrastive encoder step and
causal-LM fine-tuning.

Counterpart of ``pathway_tpu/parallel/train.py``, with the same objectives
and step semantics: symmetric InfoNCE over in-batch negatives for the
embedders, and length-masked next-token cross-entropy (plus the MoE
load-balance loss) for the decoders, full or LoRA (``models/lora.py``).
There is no Pallas kernel on the JAX training path (the encoder trains
through the Flax module forward, the decoder through its XLA trunk), so the
port trains in plain PyTorch with autograd.

What differs from the JAX functions:

* **Device or mesh.**  They take an explicit ``device`` and run on the
  first CUDA card unless the caller asks for another (``"cpu"``), or a
  keyword-only ``mesh`` (``make_mesh``'s ``("data", "model")``), one or the
  other.
* **Optimizers.**  Where the JAX signature takes an
  ``optax.GradientTransformation``, the port takes a factory that builds a
  ``torch.optim`` optimizer over a list of tensors, e.g.
  ``functools.partial(torch.optim.Adam, lr=1e-3)``: ``optax.adam(lr)`` is
  ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, with the same
  bias correction and eps outside the square root, and moments in the
  parameters' dtype, as optax's ``mu``/``nu``.
* **State.**  :class:`TrainState` holds the param tree, the optimizer
  built over its trainable leaves (its ``state_dict`` is what optax's
  ``opt_state`` holds) and the step.  A step updates the tensors of the
  tree in place and returns the state with the next step number.  Frozen
  leaves (a LoRA base) do not require grad and are not the optimizer's,
  so they stay bitwise unchanged.

**On a mesh** every rank holds the whole batch (the SPMD invariant) and
computes on its rows over ``data``; the params are DTensors (encoder
leaves placed by ``shard_params``, decoder leaves by ``tp_param_specs``,
whose forward joins the rank's shares by hand, ``models/decoder.py``).
Each rank's loss is its SHARE of the global loss: its rows' part of the
sums, over the global denominator, plus the replicated terms (InfoNCE
over the gathered embeddings, the MoE aux loss) divided by the data
size.  The shares sum to the single-device loss, so the gradients of the
shares, summed over ``data`` (:func:`apply_step`), are the single-device
gradients, and the returned loss is the sum of the shares.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.parallel.collectives import all_reduce_grads, gather_rows, own_rows

OptimizerFactory = Callable[[list], torch.optim.Optimizer]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: torch.optim.Optimizer
    step: int = 0


def named_leaves(tree, prefix: str = "") -> dict:
    """The leaves of a tree of nested dicts as ``{path: leaf}``, keys
    joined by ``/`` and sorted at every level (``jax.tree_util``'s order)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for key in sorted(tree):
        out.update(named_leaves(tree[key], f"{prefix}/{key}" if prefix else key))
    return out


def require_float(tree) -> None:
    """Raise ``ValueError`` unless every leaf is a floating tensor: an int8
    weight-only tree (``{"q", "s"}`` leaves) is for serving only."""
    for name, leaf in named_leaves(tree).items():
        if not leaf.is_floating_point():
            raise ValueError(
                f"leaf {name!r} is {leaf.dtype}: an int8 weight-only tree is for "
                "serving only; train the float tree and quantize it afterwards"
            )


def train_state(params, optimizer: OptimizerFactory, *, trainable=None) -> TrainState:
    """A step-0 :class:`TrainState` over ``params`` (nested dicts of leaf
    tensors, used as they are): the leaves that ``trainable`` marks (a tree
    of bools with ``params``' structure, e.g. ``lora_mask``; every leaf when
    ``None``) require grad and go, in :func:`named_leaves` order, to a fresh
    optimizer from ``optimizer``; the others are frozen."""
    require_float(params)
    marks = named_leaves(trainable) if trainable is not None else None
    train = []
    for name, leaf in named_leaves(params).items():
        on = True if marks is None else bool(marks[name])
        leaf.requires_grad_(on)
        if on:
            train.append(leaf)
    return TrainState(params=params, opt_state=optimizer(train))


def apply_step(state: TrainState, loss, *, data_group=None) -> tuple[TrainState, torch.Tensor]:
    """Backward from ``loss``, one optimizer step, gradients dropped.  With
    ``data_group``, ``loss`` is this rank's share: the gradients and the
    returned loss are summed over the group first."""
    loss.backward()
    loss = loss.detach()
    if data_group is not None:
        all_reduce_grads([p for g in state.opt_state.param_groups for p in g["params"]], data_group)
        dist.all_reduce(loss, group=data_group)
    state.opt_state.step()
    state.opt_state.zero_grad(set_to_none=True)
    return TrainState(params=state.params, opt_state=state.opt_state, step=state.step + 1), loss


def step_target(device=None, mesh=None):
    """``(device, data group, data size)`` of a step on ``device`` (no
    group, size 1) or on ``mesh`` (its ranks' devices and its ``data``
    axis); both raises."""
    from pathway_tpu_torch.parallel.mesh import mesh_device

    if mesh is None:
        return resolve_device(device), None, 1
    if device is not None:
        raise ValueError("pass device= or mesh=, not both: each rank of a mesh computes on its own device")
    return mesh_device(mesh), mesh.get_group("data"), mesh.size(mesh.mesh_dim_names.index("data"))


def data_rows(x, device, data_group):
    """This rank's rows of the whole batch ``x`` over ``data_group``, on
    ``device`` (all of them without a group)."""
    x = torch.as_tensor(x)
    return (x if data_group is None else own_rows(x, data_group)).to(device)


def init_train_state(module, optimizer: OptimizerFactory, *, device=None,
                     mesh=None) -> tuple[TrainState, OptimizerFactory]:
    """A contrastive :class:`TrainState` from an encoder module's weights.

    The port's modules hold their weights (``SentenceEncoderModule(cfg,
    init_params(cfg, seed))``, so the JAX ``seed`` goes to ``init_params``):
    the params are a flat dict of copies of the module's ``state_dict`` on
    ``device`` (``cuda:0`` unless given), or placed on ``mesh`` by
    ``shard_params``, every leaf trainable, in their own dtype (f32 trees
    compute in ``config.dtype``)."""
    device, _, _ = step_target(device, mesh)
    params = {name: t.detach().to(device, copy=True) for name, t in module.state_dict().items()}
    if mesh is not None:
        from pathway_tpu_torch.parallel.sharding import shard_params

        params = shard_params(params, mesh)
    return train_state(params, optimizer), optimizer


def info_nce(za, zb, temperature: float = 0.05):
    """Symmetric InfoNCE over in-batch negatives: logits ``za @ zb.T /
    temperature``, the mean of the two directions' cross-entropies against
    the diagonal."""
    logits = (za @ zb.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def contrastive_loss(module, params, ids_a, mask_a, ids_b, mask_b, *, temperature: float = 0.05):
    """:func:`info_nce` of ``module`` applied with ``params``
    (``torch.func.functional_call``, the counterpart of ``module.apply``)
    to both sides."""
    za = torch.func.functional_call(module, params, (ids_a, mask_a))
    zb = torch.func.functional_call(module, params, (ids_b, mask_b))
    return info_nce(za, zb, temperature)


def make_contrastive_train_step(module, *, device=None, mesh=None, temperature: float = 0.05) -> Callable:
    """``run(state, ids_a, mask_a, ids_b, mask_b) -> (state, loss)``: one
    step of :func:`contrastive_loss` and the state's optimizer on
    ``device`` (``cuda:0`` unless given) or on ``mesh``.  Batches are numpy
    arrays or tensors of token ids and 0/1 masks.

    On a mesh each rank embeds its rows with the whole weights (gathered
    by the differentiable ``DTensor.full_tensor``: the encoder is small and
    the math is the same), the embeddings are gathered over ``data`` by a
    differentiable all-gather, and every rank computes InfoNCE over the
    global batch, its share being ``1 / |data|`` of it."""
    device, data_group, n_data = step_target(device, mesh)

    def run(state: TrainState, ids_a, mask_a, ids_b, mask_b) -> tuple[TrainState, torch.Tensor]:
        batch = [data_rows(x, device, data_group).long() for x in (ids_a, mask_a, ids_b, mask_b)]
        if mesh is None:
            return apply_step(state, contrastive_loss(module, state.params, *batch, temperature=temperature))
        full = {name: t.full_tensor() for name, t in state.params.items()}
        za = gather_rows(torch.func.functional_call(module, full, tuple(batch[:2])), data_group)
        zb = gather_rows(torch.func.functional_call(module, full, tuple(batch[2:])), data_group)
        return apply_step(state, info_nce(za, zb, temperature) / n_data, data_group=data_group)

    return run


def next_token_sums(logits, ids, lengths):
    """``(summed NLL, count)`` of the length-masked next-token positions:
    position ``t`` predicts ``ids[:, t+1]`` for ``t < length - 1``."""
    targets = ids[:, 1:]
    logp = torch.log_softmax(logits[:, :-1, :], dim=-1)
    ll = logp.gather(-1, targets[..., None])[..., 0]
    pos = torch.arange(ids.shape[1] - 1, device=ids.device)[None, :]
    m = (pos < (lengths - 1)[:, None]).float()
    return -(ll * m).sum(), m.sum()


def masked_next_token_loss(logits, ids, lengths):
    """Length-masked next-token NLL: the mean of :func:`next_token_sums`'
    positions."""
    nll, count = next_token_sums(logits, ids, lengths)
    return nll / count.clamp_min(1.0)


def lm_loss(params, ids, lengths, cfg, *, moe_aux_weight: float = 0.01, data_group=None, n_data: int = 1):
    """The causal-LM training loss: :func:`masked_next_token_loss` of the
    all-position logits plus ``moe_aux_weight`` times the MoE aux loss
    (exactly 0 for dense configs, so one definition serves both).  With
    ``data_group`` the rows are this rank's and the loss its share: its
    summed NLL over the group's count, plus the aux loss (the global
    batch's, the same on every rank) over ``n_data``."""
    from pathway_tpu_torch.models.decoder import causal_lm_logits_and_aux

    logits, aux = causal_lm_logits_and_aux(params, ids, lengths, cfg)
    if data_group is None:
        return masked_next_token_loss(logits, ids, lengths) + moe_aux_weight * aux
    nll, count = next_token_sums(logits, ids, lengths)
    dist.all_reduce(count, group=data_group)
    return nll / count.clamp_min(1.0) + moe_aux_weight * aux / n_data


def make_lm_step_runner(cfg, *, device=None, mesh=None, moe_aux_weight: float = 0.01) -> Callable:
    """The shared causal-LM training core, ``run(state, ids, lengths) ->
    (state, loss)``: one step of :func:`lm_loss` and the state's optimizer
    on ``device`` (``cuda:0`` unless given) or on ``mesh`` (each rank's
    rows over ``data``; the state's tree placed on that mesh).  Full
    fine-tuning below and LoRA (``models/lora.py``) share it, so the loss
    and step cannot drift."""
    device, data_group, n_data = step_target(device, mesh)

    def run(state: TrainState, ids, lengths) -> tuple[TrainState, torch.Tensor]:
        ids, lengths = data_rows(ids, device, data_group).long(), data_rows(lengths, device, data_group).long()
        loss = lm_loss(state.params, ids, lengths, cfg, moe_aux_weight=moe_aux_weight, data_group=data_group,
                       n_data=n_data)
        return apply_step(state, loss, data_group=data_group)

    return run


def make_causal_lm_train_step(cfg, optimizer: OptimizerFactory, *, device=None, mesh=None,
                              moe_aux_weight: float = 0.01) -> tuple[Callable, Callable]:
    """Next-token training of the decoder family on one device or on a
    ``("data", "model")`` mesh.

    Returns ``(init_state, run)``: ``init_state(seed=0)`` draws
    ``init_decoder_params(cfg, seed)`` on ``device`` (or on every rank of
    ``mesh``, placed by ``tp_param_specs``: serving's layout, so trained
    weights drop straight into the tensor-parallel forward) and makes every
    leaf trainable; ``run`` is :func:`make_lm_step_runner`'s.  The tree is
    the serving tree, so fine-tuned weights drop straight into
    ``DecoderLM``.  ``cfg.remat`` recomputes each layer in the backward
    pass."""
    from pathway_tpu_torch.models.decoder import init_decoder_params, place_tp_params

    device, _, _ = step_target(device, mesh)

    def init_state(seed: int = 0) -> TrainState:
        tree = init_decoder_params(cfg, seed, device=device)
        return train_state(tree if mesh is None else place_tp_params(tree, cfg, mesh), optimizer)

    return init_state, make_lm_step_runner(cfg, device=None if mesh else device, mesh=mesh,
                                           moe_aux_weight=moe_aux_weight)

"""Training on one device: the contrastive encoder step and causal-LM
fine-tuning.

Counterpart of ``pathway_tpu/parallel/train.py``, with the same objectives
and step semantics: symmetric InfoNCE over in-batch negatives for the
embedders, and length-masked next-token cross-entropy (plus the MoE
load-balance loss) for the decoders, full or LoRA (``models/lora.py``).
There is no Pallas kernel on the JAX training path (the encoder trains
through the Flax module forward, the decoder through its XLA trunk), so the
port trains in plain PyTorch with autograd.

What differs from the JAX functions:

* **Device, not mesh.**  They take an explicit ``device`` and run on the
  first CUDA card unless the caller asks for another (``"cpu"``).  The mesh
  (data parallel over ``data``, tensor parallel over ``model``) arrives
  with the multi-GPU slice.
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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F

from pathway_tpu_torch.device import resolve_device

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


def apply_step(state: TrainState, loss) -> tuple[TrainState, torch.Tensor]:
    """Backward from ``loss``, one optimizer step, gradients dropped."""
    loss.backward()
    state.opt_state.step()
    state.opt_state.zero_grad(set_to_none=True)
    return TrainState(params=state.params, opt_state=state.opt_state, step=state.step + 1), loss.detach()


def _ids(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def init_train_state(module, optimizer: OptimizerFactory, *, device=None) -> tuple[TrainState, OptimizerFactory]:
    """A contrastive :class:`TrainState` from an encoder module's weights.

    The port's modules hold their weights (``SentenceEncoderModule(cfg,
    init_params(cfg, seed))``, so the JAX ``seed`` goes to ``init_params``):
    the params are a flat dict of copies of the module's ``state_dict`` on
    ``device`` (``cuda:0`` unless given), every leaf trainable, in their own
    dtype (f32 trees compute in ``config.dtype``)."""
    device = resolve_device(device)
    params = {name: t.detach().to(device, copy=True) for name, t in module.state_dict().items()}
    return train_state(params, optimizer), optimizer


def contrastive_loss(module, params, ids_a, mask_a, ids_b, mask_b, *, temperature: float = 0.05):
    """Symmetric InfoNCE over in-batch negatives: ``module`` applied with
    ``params`` (``torch.func.functional_call``, the counterpart of
    ``module.apply``) to both sides, logits ``za @ zb.T / temperature``,
    the mean of the two directions' cross-entropies against the diagonal."""
    za = torch.func.functional_call(module, params, (ids_a, mask_a))
    zb = torch.func.functional_call(module, params, (ids_b, mask_b))
    logits = (za @ zb.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def make_contrastive_train_step(module, *, device=None, temperature: float = 0.05) -> Callable:
    """``run(state, ids_a, mask_a, ids_b, mask_b) -> (state, loss)``: one
    step of :func:`contrastive_loss` and the state's optimizer on
    ``device`` (``cuda:0`` unless given).  Batches are numpy arrays or
    tensors of token ids and 0/1 masks."""
    device = resolve_device(device)

    def run(state: TrainState, ids_a, mask_a, ids_b, mask_b) -> tuple[TrainState, torch.Tensor]:
        batch = [_ids(x, device) for x in (ids_a, mask_a, ids_b, mask_b)]
        return apply_step(state, contrastive_loss(module, state.params, *batch, temperature=temperature))

    return run


def masked_next_token_loss(logits, ids, lengths):
    """Length-masked next-token NLL: position ``t`` predicts ``ids[:, t+1]``
    for ``t < length - 1``; the mean over those positions."""
    targets = ids[:, 1:]
    logp = torch.log_softmax(logits[:, :-1, :], dim=-1)
    ll = logp.gather(-1, targets[..., None])[..., 0]
    pos = torch.arange(ids.shape[1] - 1, device=ids.device)[None, :]
    m = (pos < (lengths - 1)[:, None]).float()
    return -(ll * m).sum() / m.sum().clamp_min(1.0)


def lm_loss(params, ids, lengths, cfg, *, moe_aux_weight: float = 0.01):
    """The causal-LM training loss: :func:`masked_next_token_loss` of the
    all-position logits plus ``moe_aux_weight`` times the MoE aux loss
    (exactly 0 for dense configs, so one definition serves both)."""
    from pathway_tpu_torch.models.decoder import causal_lm_logits_and_aux

    logits, aux = causal_lm_logits_and_aux(params, ids, lengths, cfg)
    return masked_next_token_loss(logits, ids, lengths) + moe_aux_weight * aux


def make_lm_step_runner(cfg, *, device=None, moe_aux_weight: float = 0.01) -> Callable:
    """The shared causal-LM training core, ``run(state, ids, lengths) ->
    (state, loss)``: one step of :func:`lm_loss` and the state's optimizer
    on ``device`` (``cuda:0`` unless given).  Full fine-tuning below and
    LoRA (``models/lora.py``) share it, so the loss and step cannot drift."""
    device = resolve_device(device)

    def run(state: TrainState, ids, lengths) -> tuple[TrainState, torch.Tensor]:
        ids, lengths = _ids(ids, device), _ids(lengths, device)
        return apply_step(state, lm_loss(state.params, ids, lengths, cfg, moe_aux_weight=moe_aux_weight))

    return run


def make_causal_lm_train_step(cfg, optimizer: OptimizerFactory, *, device=None,
                              moe_aux_weight: float = 0.01) -> tuple[Callable, Callable]:
    """Next-token training of the decoder family on one device.

    Returns ``(init_state, run)``: ``init_state(seed=0)`` draws
    ``init_decoder_params(cfg, seed)`` on ``device`` and makes every leaf
    trainable; ``run`` is :func:`make_lm_step_runner`'s.  The tree is the
    serving tree, so fine-tuned weights drop straight into ``DecoderLM``.
    ``cfg.remat`` recomputes each layer in the backward pass."""
    from pathway_tpu_torch.models.decoder import init_decoder_params

    device = resolve_device(device)

    def init_state(seed: int = 0) -> TrainState:
        return train_state(init_decoder_params(cfg, seed, device=device), optimizer)

    return init_state, make_lm_step_runner(cfg, device=device, moe_aux_weight=moe_aux_weight)

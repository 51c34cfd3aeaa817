"""LoRA adapters for the decoder family (low-rank adaptation): serving and
training.

Counterpart of ``pathway_tpu/models/lora.py``.  A targeted layer weight
becomes ``{"w": frozen base, "a": [..., H, r], "b": [..., r, O]}``, and
:func:`pathway_tpu_torch.models.decoder._mm` routes activations through
the bottleneck (``x @ w + (x @ a) @ b``), so an adapted tree serves through
dense prefill, chunked decode, the paged path of the continuous-batching
scheduler and ``verify_block`` unchanged.  Quantization and speculative
decoding (which quantizes its draft) need plain trees: :func:`merge_lora`
first; ``quantize_decoder_tree`` rejects adapted trees with that
instruction.

:func:`make_lora_train_step` trains the adapters of a frozen base on one
device, or data-parallel on a mesh with the whole tree replicated, as in
the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from pathway_tpu_torch.models.decoder import DecoderConfig, PlacedTree
from pathway_tpu_torch.parallel.train import TrainState, make_lm_step_runner, train_state

# attention projections (+ optionally the dense MLP) — the usual targets;
# MoE expert weights go through the GShard einsums, not _mm, so they are
# rejected rather than silently left unadapted
DEFAULT_TARGETS = ("wq", "wv")
_ADAPTABLE = {"wq", "wk", "wv", "wo", "wg", "wu", "wd"}


def lora_decoder_tree(
    tree,
    cfg: DecoderConfig,
    *,
    rank: int = 8,
    alpha: float = 16.0,
    targets: tuple[str, ...] = DEFAULT_TARGETS,
    seed: int = 0,
) -> dict:
    """Wrap ``targets`` layer weights as ``{"w", "a", "b"}`` LoRA leaves.

    ``a`` is normal with ``(alpha/rank)/sqrt(H)`` folded into its scale,
    ``b`` zeros, so the adapted model starts exactly equal to the base and
    the merged update is ``a @ b``.  The draws come from one
    ``torch.Generator`` on the tree's device, one target after another; the
    bits differ from the JAX package's for the same seed.  The base
    weights are the tree's own tensors, not copies.
    """
    unknown = set(targets) - _ADAPTABLE
    if unknown:
        raise ValueError(f"unknown LoRA targets {sorted(unknown)}")
    if cfg.experts and any(t in ("wg", "wu", "wd") for t in targets):
        raise ValueError(
            "LoRA on MoE expert MLP weights is not supported (they run "
            "through the GShard dispatch einsums); target the attention "
            "projections instead"
        )
    device = tree["embed"].device
    gen = torch.Generator(device=device).manual_seed(seed)
    layers = dict(tree["layers"])
    for name in targets:
        w = layers[name]
        if isinstance(w, dict):
            raise ValueError(
                f"layer weight {name!r} is already wrapped ({sorted(w)}); "
                "LoRA applies to plain float trees"
            )
        H, O = w.shape[-2], w.shape[-1]
        scale = (alpha / rank) / math.sqrt(H)
        a = torch.randn((*w.shape[:-1], rank), generator=gen, device=device, dtype=torch.float32)
        layers[name] = {
            "w": w,
            "a": (a * scale).to(w.dtype),
            "b": torch.zeros((*w.shape[:-2], rank, O), dtype=w.dtype, device=device),
        }
    return {**tree, "layers": layers}


def merge_lora(tree) -> dict:
    """Fold every ``{"w", "a", "b"}`` leaf into a plain weight:
    ``w + a.f32 @ b.f32``, cast to ``w``'s dtype.  Other leaves are the
    tree's own tensors."""
    layers = {
        name: (
            (w["w"] + w["a"].float() @ w["b"].float()).to(w["w"].dtype)
            if isinstance(w, dict) and "a" in w
            else w
        )
        for name, w in tree["layers"].items()
    }
    return {**tree, "layers": layers}


def lora_mask(tree) -> dict:
    """Nested dict of bools with the tree's structure, ``True`` at the
    trainable (adapter) leaves: those under an ``"a"`` or ``"b"`` key."""

    def mark(node, adapter: bool):
        if isinstance(node, dict):
            return {k: mark(v, adapter or k in ("a", "b")) for k, v in node.items()}
        return adapter

    return mark(tree, False)


def make_lora_train_step(
    cfg: DecoderConfig,
    base_tree,
    optimizer,
    *,
    device=None,
    mesh=None,
    rank: int = 8,
    alpha: float = 16.0,
    targets: tuple[str, ...] = DEFAULT_TARGETS,
    moe_aux_weight: float = 0.01,
    seed: int = 0,
) -> tuple[Callable, Callable]:
    """LoRA fine-tuning of a frozen ``base_tree`` on one device (``cuda:0``
    unless given; the base moves there if it is elsewhere).

    Only the adapter leaves (:func:`lora_mask`) require grad and go to the
    optimizer (a ``torch.optim`` factory, see ``parallel/train.py``): the
    semantics of optax's ``multi_transform`` with ``set_to_zero`` on the
    rest, not of ``optax.masked``.  The base stays bitwise unchanged and the
    optimizer state is the size of the adapters.  Returns ``(init_state,
    run)`` as ``TrainCheckpointer`` takes them: every ``init_state()`` has
    adapters of its own (the draws of ``seed``) over the shared base.

    On ``mesh`` (``make_mesh``'s ``("data", "model")``; ``device`` or
    ``mesh``, not both) the adapted tree is replicated on every rank
    (adapters are megabytes: data parallelism is LoRA's axis), placed once,
    and the batch splits over ``data``."""
    from pathway_tpu_torch.parallel.sharding import place_tree
    from pathway_tpu_torch.parallel.train import step_target

    device, _, _ = step_target(device, mesh)

    def on_device(node):
        return {k: on_device(v) for k, v in node.items()} if isinstance(node, dict) else node.to(device)

    tree0 = lora_decoder_tree(on_device(base_tree), cfg, rank=rank, alpha=alpha, targets=targets, seed=seed)
    if mesh is not None:
        tree0 = place_tree(tree0, mesh)
    mask = lora_mask(tree0)

    def init_state() -> TrainState:
        layers = {
            name: ({**w, "a": w["a"].clone(), "b": w["b"].clone()} if isinstance(w, dict) else w)
            for name, w in tree0["layers"].items()
        }
        tree = {**tree0, "layers": layers}
        return train_state(tree if mesh is None else PlacedTree(tree, cfg), optimizer, trainable=mask)

    return init_state, make_lm_step_runner(cfg, device=None if mesh else device, mesh=mesh,
                                           moe_aux_weight=moe_aux_weight)

"""LoRA adapters for the decoder family (low-rank adaptation), for serving.

Counterpart of ``pathway_tpu/models/lora.py``.  A targeted layer weight
becomes ``{"w": frozen base, "a": [..., H, r], "b": [..., r, O]}``, and
:func:`pathway_tpu_torch.models.decoder._mm` routes activations through
the bottleneck (``x @ w + (x @ a) @ b``), so an adapted tree serves through
dense prefill, chunked decode, the paged path of the continuous-batching
scheduler and ``verify_block`` unchanged.  Quantization and speculative
decoding (which quantizes its draft) need plain trees: :func:`merge_lora`
first; ``quantize_decoder_tree`` rejects adapted trees with that
instruction.

Not ported yet: ``make_lora_train_step`` (data-parallel adapter training
over a mesh) waits for the training slice (ROADMAP Queue 1, "Multi-GPU and
training").
"""

from __future__ import annotations

import math

import torch

from pathway_tpu_torch.models.decoder import DecoderConfig

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

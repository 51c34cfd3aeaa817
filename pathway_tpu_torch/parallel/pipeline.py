"""Pipeline parallelism for the decoder family: the GPipe schedule over a
``stage`` mesh axis.

Counterpart of ``pathway_tpu/parallel/pipeline.py``.  The decoder trunk
splits into ``n_stages`` contiguous layer groups, one per rank along a
``("stage",)`` mesh, and microbatches stream through the GPipe schedule
tick for tick as in the JAX package: ``n_micro + n_stages - 1`` ticks;
on each, every stage runs its layers on one microbatch, stage 0 takes the
next microbatch (the last one again once they are spent, as the JAX
clip does), the other stages take what their predecessor produced on the
tick before, and the activations then rotate one stage on.  Bubble ticks
run on zeros with an all-False mask (finite: a uniform softmax over a
constant row) and their results never reach the output.  Embedding and
the LM head are replicated and computed on every rank; the last stage's
outputs are broadcast to every rank.

The JAX package writes the rotation as ``ppermute`` and the broadcast as a
``psum`` inside ``shard_map`` and differentiates through them.  Here each
is an autograd function (``parallel/collectives.py``): the rotation is a
``batch_isend_irecv`` whose backward is the reverse rotation (a world of
one makes no hop); the broadcast's backward hands the last stage the
gradient of the outputs, once (every rank computes the same loss from the
broadcast outputs, so summing the ranks' gradients would multiply it by
``n_stages``); and the embedded microbatches enter the trunk through
Megatron's copy, whose backward sums the stages' gradients (only stage 0
has any).  The gradients are then those of the unpipelined step, leaf
for leaf.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

# the module, not its names: the decoder imports this package's collectives
from pathway_tpu_torch.models import decoder as dec
from pathway_tpu_torch.parallel.collectives import broadcast_from, copy_to, shift
from pathway_tpu_torch.parallel.sharding import place_tree


def make_pp_mesh(n_stages: int, *, device=None) -> DeviceMesh:
    """A 1-D ``("stage",)`` mesh over the process group's world, one stage
    per rank; ``n_stages`` other than the world's size raises."""
    from pathway_tpu_torch.parallel.mesh import world_mesh

    return world_mesh((n_stages,), ("stage",), device=device)


def stack_stages(tree, n_stages: int) -> dict:
    """Reshape the decoder's stacked layer tree ``[L, ...]`` into
    ``[n_stages, L / n_stages, ...]`` so stage ``s`` owns rows ``[s]``."""
    L = next(iter(tree["layers"].values())).shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    return {**tree, "layers": {k: v.reshape(n_stages, L // n_stages, *v.shape[1:]) for k, v in tree["layers"].items()}}


def pp_param_specs(tree, axis: str = "stage") -> dict:
    """Specs (``PartitionSpec`` tuples) of the stage-stacked ``tree``: every
    layer leaf, dense or MoE, splits its leading stage axis; embed, norm
    and head are replicated (computed off the pipeline)."""
    return {
        "embed": (None, None),
        "final_norm": (None,),
        "lm_head": (None, None),
        "layers": {k: (axis,) for k in tree["layers"]},
    }


def place_pp_params(tree, mesh: DeviceMesh) -> dict:
    """Stack ``tree`` by the mesh's stage count and place it: each rank
    keeps its stage's layers ``[1, L / n_stages, ...]``."""
    stacked = stack_stages(tree, mesh.size(0))
    return place_tree(stacked, mesh, pp_param_specs(stacked))


def _stage_forward(stage_layers, x, valid, cfg: dec.DecoderConfig):
    """Run one stage's layers (``{name: [Lps, ...]}``) over activations
    ``x [mb, S, H]`` with key validity ``valid [mb, S]``; with ``cfg.remat``
    each layer is recomputed in the backward pass."""
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    if cfg.sliding_window is not None:
        causal = causal & dec._sw_mask(pos[:, None], pos[None, :], cfg.sliding_window)
    mask = causal[None, :, :] & (valid > 0)[:, None, :]
    rope = dec._rope_tables(pos[None, :].expand(x.shape[0], S), cfg.head_dim, cfg.rope_theta)

    def layer(lp, x):
        # the pipelined trunk is a serving path (MoE training under pp is
        # rejected), so MoE dispatch runs lossless
        return dec.decoder_layer(lp, x, rope, mask, cfg, full_capacity=True)[0]

    remat = cfg.remat and torch.is_grad_enabled()
    cols = {name: dec._unstack(w) for name, w in stage_layers.items()}
    for vals in zip(*cols.values()):
        lp = dict(zip(cols, vals))
        x = torch.utils.checkpoint.checkpoint(layer, lp, x, use_reentrant=False) if remat else layer(lp, x)
    return x


def make_pipelined_causal_lm(cfg: dec.DecoderConfig, mesh: DeviceMesh, n_micro: int) -> Callable:
    """Pipelined all-position logits: ``fn(tree, ids, lengths) -> [B, S, V]``
    f32, on every rank.

    ``tree`` is a stage-stacked tree placed by :func:`place_pp_params`;
    ``ids`` and ``lengths`` are the whole batch on every rank, and ``B =
    n_micro × mb`` splits into microbatches along its leading axis.  The
    schedule changes the order of the computation, not its math: the
    logits are ``causal_lm_logits``'s.  MoE configs pipeline with lossless
    dispatch, as in the JAX package, so they match ``causal_lm_logits``
    (which drops at capacity) only where nothing is dropped."""
    n_stages = mesh.size(0)
    group = mesh.get_group(0)
    stage = mesh.get_local_rank(0)
    n_ticks = n_micro + n_stages - 1

    def fn(tree, ids, lengths):
        B, S = ids.shape
        if B % n_micro:
            raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
        mb = B // n_micro
        layers = {k: v.to_local()[0] for k, v in tree["layers"].items()}
        x = tree["embed"].to_local()[ids]  # [B, S, H]
        valid = (torch.arange(S, device=ids.device)[None, :] < lengths[:, None]).long()
        xs = copy_to(x, group).reshape(n_micro, mb, S, cfg.hidden)
        valids = valid.reshape(n_micro, mb, S)
        state_x, state_valid = torch.zeros_like(xs[0]), torch.zeros_like(valids[0])
        first = torch.tensor(stage == 0, device=ids.device)
        outputs = []
        # every stage runs the same code (the JAX program is SPMD): the
        # selections are wheres, so each rank's backward visits the same
        # rotations in the same order, and their exchanges pair up
        for t in range(n_ticks):
            inj = min(t, n_micro - 1)
            x_in = torch.where(first, xs[inj], state_x)
            valid_in = torch.where(first, valids[inj], state_valid)
            y = _stage_forward(layers, x_in, valid_in, cfg)
            if t >= n_stages - 1:
                outputs.append(y)
            state_x, state_valid = shift(y, group), shift(valid_in, group)
        # only the last stage's outputs are the trunk's; the broadcast gives
        # them to every rank (and their gradient to the last stage alone)
        out = broadcast_from(torch.stack(outputs), group, n_stages - 1).reshape(B, S, cfg.hidden)
        out = dec._rms(out, tree["final_norm"].to_local(), cfg.norm_eps)
        return (out @ tree["lm_head"].to_local()).float()

    return fn


def make_pp_train_step(cfg: dec.DecoderConfig, optimizer, mesh: DeviceMesh, n_micro: int) -> tuple[Callable, Callable]:
    """Pipeline-parallel next-token training.

    Returns ``(init_state, run)``: ``init_state(seed=0)`` draws
    ``init_decoder_params(cfg, seed)`` on every rank and places it by
    :func:`place_pp_params`, every leaf trainable; ``run(state, ids,
    lengths) -> (state, loss)`` takes the whole batch on every rank.  The
    loss is ``make_causal_lm_train_step``'s (the masked next-token NLL) over
    the pipelined logits, the same on every rank, and its gradients are the
    unpipelined step's.  An MoE config raises ``NotImplementedError`` (the
    aux loss is not threaded through the schedule), as in the JAX
    package."""
    from pathway_tpu_torch.parallel.mesh import mesh_device
    from pathway_tpu_torch.parallel.train import TrainState, apply_step, masked_next_token_loss, train_state

    if cfg.experts:
        raise NotImplementedError(
            "pipeline-parallel MoE training is not supported: the MoE "
            "load-balance aux loss is not threaded through the GPipe "
            "schedule (it would be silently dropped) — train MoE decoders "
            "with make_causal_lm_train_step (dp×tp×ep) instead; the "
            "pipelined FORWARD supports MoE configs"
        )
    device = mesh_device(mesh)
    fwd = make_pipelined_causal_lm(cfg, mesh, n_micro)

    def init_state(seed: int = 0) -> TrainState:
        return train_state(place_pp_params(dec.init_decoder_params(cfg, seed, device=device), mesh), optimizer)

    def run(state: TrainState, ids, lengths) -> tuple[TrainState, torch.Tensor]:
        ids = torch.as_tensor(ids, device=device).long()
        lengths = torch.as_tensor(lengths, device=device).long()
        return apply_step(state, masked_next_token_loss(fwd(state.params, ids, lengths), ids, lengths))

    return init_state, run

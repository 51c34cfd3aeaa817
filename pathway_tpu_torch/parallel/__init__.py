"""Parallel layers and training of the PyTorch port.

The multi-device mesh on ``torch.distributed`` (one rank per card, NCCL
between cards and gloo between CPU ranks): ``("data", "model")`` meshes,
DTensor placement of parameters and batches, the corpus-sharded index
top-k and ring attention over a sequence-sharded axis; the decoder's
tensor-parallel layout (``models/decoder.py``), expert parallelism for the
Mixtral mixture-of-experts FFN, the GPipe pipeline, and the data- and
tensor-parallel train steps (contrastive encoder, causal LM, MoE) with
their sharded checkpoints; ``dryrun_multichip`` runs one step of each.
The collectives and their gradients are written by hand
(``collectives.py``): one process per card, where XLA inserts them for
the JAX package.
"""

from pathway_tpu_torch.parallel.checkpoint import TrainCheckpointer
from pathway_tpu_torch.parallel.dryrun import dryrun_multichip
from pathway_tpu_torch.parallel.index import ShardedDeviceIndex, sharded_topk
from pathway_tpu_torch.parallel.mesh import (
    flat_axes,
    get_default_index_mesh,
    initialize_distributed,
    make_mesh,
    mesh_shape_for,
    put_global,
    set_default_index_mesh,
    world_mesh,
)
from pathway_tpu_torch.parallel.moe import (
    MoEConfig,
    ep_param_specs,
    init_moe_params,
    make_ep_mesh,
    make_moe_train_step,
    moe_ffn,
)
from pathway_tpu_torch.parallel.pipeline import (
    make_pipelined_causal_lm,
    make_pp_mesh,
    make_pp_train_step,
    place_pp_params,
    pp_param_specs,
)
from pathway_tpu_torch.parallel.ring_attention import ring_encoder_attention
from pathway_tpu_torch.parallel.sharding import place_tree, replicated, shard_batch, shard_params, spec_placements
from pathway_tpu_torch.parallel.train import (
    TrainState,
    init_train_state,
    make_causal_lm_train_step,
    make_contrastive_train_step,
    make_lm_step_runner,
    masked_next_token_loss,
    train_state,
)

__all__ = [
    "MoEConfig",
    "dryrun_multichip",
    "ep_param_specs",
    "make_ep_mesh",
    "make_pipelined_causal_lm",
    "make_pp_mesh",
    "make_pp_train_step",
    "place_pp_params",
    "place_tree",
    "pp_param_specs",
    "spec_placements",
    "world_mesh",
    "ShardedDeviceIndex",
    "TrainCheckpointer",
    "TrainState",
    "flat_axes",
    "get_default_index_mesh",
    "init_moe_params",
    "init_train_state",
    "initialize_distributed",
    "make_causal_lm_train_step",
    "make_contrastive_train_step",
    "make_lm_step_runner",
    "make_mesh",
    "make_moe_train_step",
    "masked_next_token_loss",
    "mesh_shape_for",
    "moe_ffn",
    "put_global",
    "replicated",
    "ring_encoder_attention",
    "set_default_index_mesh",
    "shard_batch",
    "shard_params",
    "sharded_topk",
    "train_state",
]

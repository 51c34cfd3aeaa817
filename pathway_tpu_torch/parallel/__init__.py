"""Parallel layers and training of the PyTorch port.

The multi-device mesh on ``torch.distributed`` (one rank per card, NCCL
between cards and gloo between CPU ranks): ``("data", "model")`` meshes,
DTensor placement of parameters and batches, the corpus-sharded index
top-k and ring attention over a sequence-sharded axis.  Then the Mixtral
mixture-of-experts FFN, the one-device train steps (contrastive encoder,
causal LM, MoE) and training-state checkpoints.
"""

from pathway_tpu_torch.parallel.checkpoint import TrainCheckpointer
from pathway_tpu_torch.parallel.index import ShardedDeviceIndex, sharded_topk
from pathway_tpu_torch.parallel.mesh import (
    flat_axes,
    get_default_index_mesh,
    initialize_distributed,
    make_mesh,
    mesh_shape_for,
    put_global,
    set_default_index_mesh,
)
from pathway_tpu_torch.parallel.moe import MoEConfig, init_moe_params, make_moe_train_step, moe_ffn
from pathway_tpu_torch.parallel.ring_attention import ring_encoder_attention
from pathway_tpu_torch.parallel.sharding import replicated, shard_batch, shard_params
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

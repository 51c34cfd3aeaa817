"""Parallel layers and training of the PyTorch port: the Mixtral
mixture-of-experts FFN, the one-device train steps (contrastive encoder,
causal LM, MoE) and training-state checkpoints.  The multi-device mesh
waits for the multi-GPU slice."""

from pathway_tpu_torch.parallel.checkpoint import TrainCheckpointer
from pathway_tpu_torch.parallel.moe import MoEConfig, init_moe_params, make_moe_train_step, moe_ffn
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
    "TrainCheckpointer",
    "TrainState",
    "init_moe_params",
    "init_train_state",
    "make_causal_lm_train_step",
    "make_contrastive_train_step",
    "make_lm_step_runner",
    "make_moe_train_step",
    "masked_next_token_loss",
    "moe_ffn",
    "train_state",
]

"""Models of the PyTorch port."""

from pathway_tpu_torch.models.encoder import (
    CrossEncoder,
    EncoderConfig,
    SentenceEncoder,
    config_for,
    shared_cross_encoder,
    shared_sentence_encoder,
)
from pathway_tpu_torch.models.tokenizer import HashTokenizer, load_tokenizer
from pathway_tpu_torch.models.lora import (
    lora_decoder_tree,
    make_lora_train_step,
    merge_lora,
)

__all__ = [
    "CrossEncoder",
    "EncoderConfig",
    "HashTokenizer",
    "SentenceEncoder",
    "config_for",
    "load_tokenizer",
    "lora_decoder_tree",
    "make_lora_train_step",
    "merge_lora",
    "shared_cross_encoder",
    "shared_sentence_encoder",
]

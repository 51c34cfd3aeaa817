"""pathway_tpu_torch — the PyTorch/CUDA port of ``pathway_tpu``.

The streaming embed-and-retrieve path: text → sentence encoder (with a
hand-written CUDA encoder-attention kernel) → L2-normalised vectors → a
device-resident brute-force index → masked top-k.  Reranking: the
``CrossEncoder`` scores (query, document) pairs over the same trunk and
kernel; both encoders serve W8A8 on request.  Decoder generation:
``DecoderLM`` (dense KV cache; dense or Mixtral MoE layers, bf16 or
weight-only int8, plain or self-speculative greedy decoding) and the
continuous-batching ``GenerationScheduler`` over a paged KV cache; a
LoRA-adapted tree (``models/lora.py``'s ``lora_decoder_tree``) serves
through both unchanged.  Multimodal embedding: ``MultimodalEncoder`` (a
SigLIP ViT image tower and a projected text tower in one space, with
SigLIP's pairwise logits).  Entry points run on the first CUDA device
unless the caller passes ``device=`` (``"cpu"`` runs the kernels' plain
PyTorch versions).  The port imports nothing of JAX or of
``pathway_tpu``.
"""

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.models.decoder import DecoderLM
from pathway_tpu_torch.models.encoder import CrossEncoder, SentenceEncoder
from pathway_tpu_torch.models.vision import MultimodalEncoder
from pathway_tpu_torch.serving.generation import GenerationScheduler
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnnIndex,
    DistanceMetric,
)

__all__ = [
    "BruteForceKnnIndex",
    "CrossEncoder",
    "DecoderLM",
    "DistanceMetric",
    "GenerationScheduler",
    "MultimodalEncoder",
    "SentenceEncoder",
    "resolve_device",
]

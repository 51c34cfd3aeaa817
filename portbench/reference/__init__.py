"""Plain float32 PyTorch reference of what the benchmark's cells compute.

Frozen copies of the port's hash tokenizer and token-count splitter rule,
a BERT encoder, a Mistral decoder and an exact top-k.  Nothing here
imports the program or JAX, and nothing takes a tensor the program made:
the harness hands both sides the same seeded weights and inputs.
"""

import torch


def strict_f32() -> None:
    """Float32 products stay float32 on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

"""Plain PyTorch and NumPy references that decide ``correct``. They import
nothing of the program (``probing_rag_tpu_torch``) and nothing of JAX, and
take only what the benchmark made: weights, corpus, questions and passages.
Run in float32 with TF32 off (``exact_matmuls``)."""

import torch


def exact_matmuls() -> None:
    """float32 products in float32: TF32 would round their inputs to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

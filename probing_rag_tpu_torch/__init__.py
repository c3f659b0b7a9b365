"""probing-rag-tpu on PyTorch and CUDA: the adaptive retrieval-augmented
generation path of ``probing_rag_tpu`` (JAX) ported to one NVIDIA Hopper
GPU.

The module tree mirrors ``probing_rag_tpu``; each module names the JAX
module it ports. The BM25 and dense searches and the int8-weight LM
matmuls run on hand-written CUDA kernels (``kernels/csrc``) with a plain
PyTorch version of each beside it, which the wrappers take for tensors on
the CPU. This package imports torch and numpy, and nothing of jax or of
``probing_rag_tpu``: the host-only modules it needs (``data``, ``eval``)
are copies, held equal to their JAX twins by the tests.
"""

__version__ = "0.1.0"

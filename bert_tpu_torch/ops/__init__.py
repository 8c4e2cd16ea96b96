"""Ops of the encoder: each module holds a hand-written CUDA kernel for the
H100, its wrapper, and the plain PyTorch version the wrapper runs for CPU
tensors. Importing the package imports every wrapper module, so the
registry of their launch counters (``common.COUNTERS``) is complete."""

from . import (attention, fused_attention, int8_matmul,  # noqa: F401
               layer_norm, mla_attention, moe, q4_matmul)

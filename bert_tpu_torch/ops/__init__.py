"""Ops of the encoder: each module holds a hand-written CUDA kernel for the
H100, its wrapper, and the plain PyTorch version the wrapper runs for CPU
tensors."""

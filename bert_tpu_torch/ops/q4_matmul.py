"""Fused INT4-dequant + matmul: ``x[M, K] @ dequant(W)[K, N] → f32[M, N]``.

Counterpart of ``bert_tpu/ops/q4_matmul.py``. On the H100 the fused kernel
is ``bert_tpu_torch/csrc/q4_matmul.cu`` (it replaces the Pallas
``_q4_matmul_kernel``; the source says what bounds it and how the simple
design copes). Weights use the group-local layout of
:mod:`bert_tpu_torch.quant`: ``packed[K//2, N]`` uint8, ``scales[K//32, N]``
f32 and, for Q4_1, ``mins[K//32, N]`` f32.

:func:`q4_matmul_plain` is the plain PyTorch version. It mirrors the JAX
package's jnp path (``q4_dequantize_jnp`` then an f32-accumulating dot),
which is what the JAX model runs on a CPU. Its rounding differs from the
kernel's in one place: it multiplies code and scale in x's dtype (so a
bf16 x rounds the scale to bf16 first), where the kernel dequantizes in
f32 and rounds the weight once, as the Pallas kernel does.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..quant import GROUP, QK, QuantTensor

# Router: the fused kernel for M ≤ FUSED_MAX_M rows, dequantize-then-matmul
# above. 2048 was measured on a TPU v5e (bert_tpu/ops/q4_matmul.py:177-183);
# it has not been measured on the H100 yet (ROADMAP.md).
FUSED_MAX_M = 2048


def q4_dequantize(qt: QuantTensor, dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """QuantTensor of tensors → dense W[K, N] in ``dtype`` (mirrors
    ``q4_dequantize_jnp``: codes and scales meet in ``dtype``)."""
    half, n = qt.packed.shape
    p = qt.packed.to(torch.int32).reshape(half // QK, QK, n)
    # group g: low nibbles = q4 block 2g, high nibbles = block 2g+1
    codes3 = torch.cat([p & 0xF, p >> 4], dim=1).reshape(
        half * 2 // QK, QK, n)  # block-major, aligned with the scales
    scales = qt.scales[:, None, :].to(dtype)
    if qt.mins is None:
        w3 = (codes3 - 8).to(dtype) * scales
    else:
        w3 = codes3.to(dtype) * scales + qt.mins[:, None, :].to(dtype)
    return w3.reshape(half * 2, n)


def q4_matmul_plain(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """Plain version: dequantize in x's dtype, multiply with f32
    accumulation (mirrors ``_q4_matmul_jnp``). TF32 is off package-wide,
    so on the card this is a true f32 product."""
    w = q4_dequantize(qt, dtype=x.dtype)
    return torch.matmul(x.float(), w.float())


def _check_operands(x: torch.Tensor, qt: QuantTensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"q4_matmul: x must be [M, K], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q4_matmul: x dtype {x.dtype} not in (f32, bf16)")
    m, k = x.shape
    if k % GROUP:
        raise ValueError(f"q4_matmul: K={k} not a multiple of {GROUP}")
    n = qt.packed.shape[-1]
    expect = {"packed": ((k // 2, n), torch.uint8),
              "scales": ((k // QK, n), torch.float32)}
    if qt.mins is not None:
        expect["mins"] = ((k // QK, n), torch.float32)
    for name, (shape, dtype) in expect.items():
        t = getattr(qt, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"q4_matmul: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"q4_matmul: {name} must be contiguous on "
                             f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("q4_matmul: x must be contiguous")


def _launch(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    m, k = x.shape
    n = qt.packed.shape[-1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    fn = "q4_matmul_f32" if x.dtype == torch.float32 else "q4_matmul_bf16"
    lib = _kernels.library("q4_matmul")
    with torch.cuda.device(x.device):
        rc = getattr(lib, fn)(
            x.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(),
            None if qt.mins is None else qt.mins.data_ptr(), out.data_ptr(),
            m, k, n, _kernels.stream_of(x))
    _kernels.check(rc, fn)
    q4_matmul.launches += 1
    return out


def q4_matmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """``x[M, K] @ dequant(qt)[K, N] → f32[M, N]``.

    CPU tensors take :func:`q4_matmul_plain`. CUDA tensors with
    M ≤ FUSED_MAX_M launch the kernel (or raise); larger M takes the
    router's other branch, dequantize-then-matmul, as the JAX package
    sends it to XLA's dot."""
    if x.device.type == "cpu":
        return q4_matmul_plain(x, qt)
    if x.device.type != "cuda":
        raise ValueError(f"q4_matmul: unsupported device {x.device}")
    _check_operands(x, qt)
    if x.shape[0] > FUSED_MAX_M:
        return q4_matmul_plain(x, qt)
    return _launch(x, qt)


q4_matmul.launches = 0  # kernel launches, counted where they happen

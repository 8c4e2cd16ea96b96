"""Fused INT4-dequant + matmul: ``x[M, K] @ dequant(W)[K, N] → f32[M, N]``.

Counterpart of ``bert_tpu/ops/q4_matmul.py``. On the H100 the fused kernel
is ``bert_tpu_torch/csrc/q4_matmul.cu`` (it replaces the Pallas
``_q4_matmul_kernel``; the source says what bounds it and how its
tensor-core design copes). Weights use the group-local layout of
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

# Router: the fused kernel for M ≤ fused_max_m(x.dtype) rows,
# dequantize-then-matmul above; chip_smoke.py's router phase times both at
# 1,024-16,384 rows at the QKV and FFN-up shapes and logs the threshold its
# measurement gives (PERF.md). On an NVIDIA H100 80GB HBM3 at 700 W the
# bf16 kernel beat the plain branch at every M measured, by more than 4x
# at 16,384 rows, so FUSED_MAX_M is the largest M measured. So did the
# f32 instance (the six-product split on the tensor cores) against the
# plain branch's f32 cuBLAS GEMM, at both shapes at every M measured (by
# 13% and more at 16,384 rows), so FUSED_MAX_M_F32 is the largest M
# measured too. They are kept apart because each follows its own
# measurement: the f32 instance's first design (CUDA cores) lost at every
# M.
FUSED_MAX_M = 16384
FUSED_MAX_M_F32 = 16384


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


def load_alignment(n: int) -> dict:
    """Byte alignment the kernel's loads need of each operand at N = n, in
    either dtype: x rows by 16 bytes (TMA tiles or 16-byte cp.async); the
    packed band by 16 where N % 16 == 0 (the TMA instance), else by the
    cp.async instance's 4 or 1 bytes; the scale and min rows by 16 or 4, the
    widest that N's row stride allows."""
    band = 16 if n % 16 == 0 else 4 if n % 4 == 0 else 1
    rows = 16 if n % 4 == 0 else 4
    return {"x": 16, "packed": band, "scales": rows, "mins": rows}


def _check_alignment(x: torch.Tensor, qt: QuantTensor) -> None:
    """Raise where an operand (a per-layer slice, say) is not aligned for
    the kernel's loads; never fall back."""
    need = load_alignment(qt.packed.shape[-1])
    for name, t in (("x", x), ("packed", qt.packed), ("scales", qt.scales),
                    ("mins", qt.mins)):
        if t is not None and t.data_ptr() % need[name]:
            raise ValueError(f"q4_matmul: {name} at 0x{t.data_ptr():x} is "
                             f"not {need[name]}-byte aligned")


def _launch(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    m, k = x.shape
    n = qt.packed.shape[-1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    _check_alignment(x, qt)
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
    M ≤ :func:`fused_max_m` rows launch the kernel (or raise); larger M
    takes the router's other branch, dequantize-then-matmul, as the JAX
    package sends it to XLA's dot."""
    if x.device.type == "cpu":
        return q4_matmul_plain(x, qt)
    if x.device.type != "cuda":
        raise ValueError(f"q4_matmul: unsupported device {x.device}")
    _check_operands(x, qt)
    if x.shape[0] > fused_max_m(x.dtype):
        return q4_matmul_plain(x, qt)
    return _launch(x, qt)


def fused_max_m(dtype: torch.dtype) -> int:
    """The router's threshold for x of ``dtype``."""
    return FUSED_MAX_M if dtype == torch.bfloat16 else FUSED_MAX_M_F32


q4_matmul.launches = 0  # kernel launches, counted where they happen

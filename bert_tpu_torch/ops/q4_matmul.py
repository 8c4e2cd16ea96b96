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

# Router. A CUDA tensor always launches a kernel (or raises), of one of
# two designs in csrc/q4_matmul.cu, chosen by what the call's shape shows:
# - bf16 at M >= WGMMA_MIN_M rows with N % 16 == 0: the wgmma instance.
#   At bulk M the product is bound by operations (bert-base's QKV at M =
#   8,192: 29 GFLOP, 29 us at 989 TFLOP/s, against 15 us of bytes), and
#   only wgmma reaches the tensor cores' full rate: persistent blocks whose
#   consumers dequantize W into wgmma's register operand and store the f32
#   output by TMA while the next tile's products run.
# - Below WGMMA_MIN_M, at N % 16 != 0 (no TMA), and for f32: the mma.sync
#   instances, 64-row tiles, one a block, whose many small blocks suit
#   small M, where the grid and the per-group latency set the time.
# chip_smoke.py's router phase times both bf16 designs and the plain
# version at bert-base's four shapes over M = 128-65,536 and logs the
# crossover its measurement gives, which WGMMA_MIN_M follows (PERF.md). On
# an NVIDIA H100 80GB HBM3 at 700 W the wgmma instance won at all four
# shapes at every M from 512 rows up (at 512, attention-out by 3%, the
# others by 18-41%; by 2.4-3.0x from 8,192 up) and lost attention-out
# at 128 and 256 rows, where a few tiles leave most SMs idle. At
# MiniLM's widths it won at 1,024 rows but attention-out (N = 384), and
# all four at 2,048.
# bf16 has no plain branch on the card: fused_max_m(bf16) is BF16_MAX_M,
# 2**31 - 1 (the kernels' int M), above every M an engine forms.
# f32 keeps its own: the f32 mma.sync instance (the six-product split on
# the tensor cores) beat the plain branch's f32 cuBLAS GEMM at both shapes
# at every M measured, 1,024-16,384 (by 13% and more at 16,384 rows), so
# FUSED_MAX_M_F32 is the largest M measured; above it an f32 x takes
# q4_matmul_plain.
WGMMA_MIN_M = 512
BF16_MAX_M = 2 ** 31 - 1
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


# the C entry point of each (dtype, instance)
_ENTRY = {(torch.float32, "mma"): "q4_matmul_f32",
          (torch.bfloat16, "mma"): "q4_matmul_bf16",
          (torch.bfloat16, "wgmma"): "q4_matmul_bf16_wgmma"}


def _launch(x: torch.Tensor, qt: QuantTensor, instance: str = "mma"
            ) -> torch.Tensor:
    m, k = x.shape
    n = qt.packed.shape[-1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    _check_alignment(x, qt)
    fn = _ENTRY[x.dtype, instance]
    lib = _kernels.library("q4_matmul")
    with torch.cuda.device(x.device):
        rc = getattr(lib, fn)(
            x.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(),
            None if qt.mins is None else qt.mins.data_ptr(), out.data_ptr(),
            m, k, n, _kernels.stream_of(x))
    _kernels.check(rc, fn)
    q4_matmul.launches += 1
    if instance == "wgmma":
        q4_matmul.wgmma.launches += 1
    return out


def route(m: int, n: int, dtype: torch.dtype, device_type: str) -> str:
    """Where ``q4_matmul`` sends x[m, K] of ``dtype`` on ``device_type``
    against a weight of N = ``n`` columns: ``"plain"``
    (:func:`q4_matmul_plain`), ``"mma"`` (the mma.sync instances) or
    ``"wgmma"`` (the bulk-M bf16 instance); the router's comment says
    why."""
    if device_type == "cpu" or m > fused_max_m(dtype):
        return "plain"
    if dtype == torch.bfloat16 and m >= WGMMA_MIN_M and n % 16 == 0:
        return "wgmma"
    return "mma"


def q4_matmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """``x[M, K] @ dequant(qt)[K, N] → f32[M, N]``.

    CPU tensors take :func:`q4_matmul_plain`. CUDA tensors launch a kernel
    (or raise), the instance :func:`route` picks; only an f32 x of more
    than :func:`fused_max_m` rows takes the router's other branch,
    dequantize-then-matmul, as the JAX package sends it to XLA's dot."""
    if x.device.type == "cpu":
        return q4_matmul_plain(x, qt)
    if x.device.type != "cuda":
        raise ValueError(f"q4_matmul: unsupported device {x.device}")
    _check_operands(x, qt)
    where = route(x.shape[0], qt.packed.shape[-1], x.dtype, "cuda")
    if where == "plain":
        return q4_matmul_plain(x, qt)
    return _launch(x, qt, where)


def fused_max_m(dtype: torch.dtype) -> int:
    """The most rows a CUDA x of ``dtype`` takes to a kernel."""
    return BF16_MAX_M if dtype == torch.bfloat16 else FUSED_MAX_M_F32


class _Count:
    """The launches of one instance, kept as the wrappers keep theirs
    (``.launches``, which the engine's CUDA graphs add at each replay)."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


q4_matmul.launches = 0  # kernel launches, counted where they happen
q4_matmul.wgmma = _Count("q4_matmul.wgmma")  # of them, the wgmma instance's

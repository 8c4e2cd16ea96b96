"""Fused (pre-bias + residual +) LayerNorm: ``LN(x [+ pre_bias] [+ residual])``.

Counterpart of ``bert_tpu/ops/layer_norm.py``. On the H100 the kernel is
``bert_tpu_torch/csrc/layer_norm.cu`` (it replaces the Pallas
``_ln_kernel``, ``_ln_res_kernel`` and ``_ln_res_pb_kernel`` with one
kernel whose residual and pre-bias operands are optional). f32 statistics,
biased variance, ``(x - mean) * rsqrt(var + eps) * scale + bias`` cast to
the output dtype (bert.cpp:806-814 semantics), at any D.

What bounds the kernel on the card is bytes, and at the paths' sizes (1-4
MB a call) the latency of one round trip to device memory: a row's every
load has to be in flight before the first reduction. So a group of 8, 16
or 32 lanes owns a row held in registers, moving 16 bytes a lane-access
where D allows it (D % 8 == 0 for a bf16 output, D % 4 == 0 for f32), 4
bytes where a bf16 row is even, one element otherwise; scale, bias and
pre-bias are loaded once per thread. Rows wider than the registers hold
(D > 1024 on the 16-byte paths) take one block per row. Each operand must
be aligned for the path its shape takes; :func:`_check_alignment` raises
where it is not (never a fallback).

``out_dtype`` (default x's dtype) lets x be the f32 product of a matmul
while the residual and the output are bf16: the kernel rounds each x
element to bf16 first, so the result is bit for bit ``x.to(bf16)``
followed by the bf16 kernel, in one launch.

:func:`layer_norm_plain` mirrors ``layer_norm_jnp``, what the JAX model runs
on a CPU. Its rounding differs from the kernel's: it adds ``pre_bias`` and
``residual`` in x's dtype before widening to f32, where the kernel (like
the Pallas kernels) widens first and adds in f32.

The codes form (:func:`fused_layer_norm_codes`, for a W8A8 product that
takes the output: ``model.py``'s int8 branch) also writes the output's
per-row int8 activation codes and scales, as
``ops/int8_matmul.quantize_activations_i8`` would make them from the
rounded output, from the same registers: one more reduction a row, and
no launch or read of the output to quantize it. Its plain version is
:func:`layer_norm_plain`, then ``quantize_activations_i8_plain``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _kernels
from . import int8_matmul as _i8
from .common import round_up

_ENTRY = {(torch.float32, torch.float32): "layer_norm_f32",
          (torch.bfloat16, torch.bfloat16): "layer_norm_bf16",
          (torch.float32, torch.bfloat16): "layer_norm_f32_bf16"}


def layer_norm_plain(x, scale, bias, eps, residual=None, pre_bias=None):
    """Plain version (mirrors ``layer_norm_jnp``)."""
    if pre_bias is not None:
        x = x + pre_bias.to(x.dtype)
    if residual is not None:
        x = x + residual
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def vector_width(d: int, out_dtype: torch.dtype) -> int:
    """Elements the kernel moves per lane-access for rows of ``d``: 16
    bytes of the output type where ``d`` allows it, 4 bytes for an even
    bf16 row, else one element (``csrc/layer_norm.cu`` picks the same)."""
    if out_dtype == torch.bfloat16:
        return 8 if d % 8 == 0 else 2 if d % 2 == 0 else 1
    return 4 if d % 4 == 0 else 1


def _check_alignment(x, residual, pre_bias, scale, bias,
                     out_dtype: torch.dtype) -> None:
    """Raise where an operand is not aligned for the vector its row takes:
    ``min(16, width * element size)`` bytes; never fall back."""
    d = x.shape[-1]
    n = vector_width(d, out_dtype)
    for name, t in (("x", x), ("residual", residual), ("pre_bias", pre_bias),
                    ("scale", scale), ("bias", bias)):
        if t is None:
            continue
        need = min(16, n * t.element_size())
        if t.data_ptr() % need:
            raise ValueError(f"fused_layer_norm: {name} at "
                             f"0x{t.data_ptr():x} is not {need}-byte aligned "
                             f"(D {d}, {n}-element vectors)")


def _launch(x, scale, bias, eps, residual, pre_bias, out_dtype, codes=False):
    d = x.shape[-1]
    fn = _ENTRY.get((x.dtype, out_dtype))
    if fn is None:
        raise TypeError(f"fused_layer_norm: {x.dtype} -> {out_dtype} not in "
                        "(f32 -> f32, bf16 -> bf16, f32 -> bf16)")
    if d == 0:
        raise ValueError("fused_layer_norm: D = 0")
    if not x.is_contiguous():
        raise ValueError("fused_layer_norm: x must be contiguous")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != out_dtype
                                 or residual.device != x.device
                                 or not residual.is_contiguous()):
        raise ValueError(f"fused_layer_norm: residual must be contiguous "
                         f"{out_dtype} {tuple(x.shape)} on {x.device}")
    for name, p in (("scale", scale), ("bias", bias), ("pre_bias", pre_bias)):
        if p is None and name == "pre_bias":
            continue
        if (tuple(p.shape) != (d,) or p.dtype != torch.float32
                or p.device != x.device or not p.is_contiguous()):
            raise ValueError(f"fused_layer_norm: {name} must be contiguous "
                             f"f32 [{d}] on {x.device}")
    _check_alignment(x, residual, pre_bias, scale, bias, out_dtype)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    m = x.numel() // d
    if codes:
        fn = fn.replace("layer_norm_", "layer_norm_codes_")
        q = (torch.empty((m, round_up(d, _i8.KP_ALIGN)), dtype=torch.int8,
                         device=x.device),
             torch.empty((m,), dtype=torch.float32, device=x.device))
    if m == 0:
        return (out, *q) if codes else out
    lib = _kernels.library("layer_norm")
    with torch.cuda.device(x.device):
        rc = getattr(lib, fn)(
            x.data_ptr(),
            None if residual is None else residual.data_ptr(),
            None if pre_bias is None else pre_bias.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            *((q[0].data_ptr(), q[1].data_ptr()) if codes else ()), m, d,
            float(eps), _kernels.stream_of(x))
    _kernels.check(rc, fn)
    if codes:
        fused_layer_norm_codes.launches += 1
        return (out, *q)
    fused_layer_norm.launches += 1
    return out


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, *, eps: float,
                     residual: Optional[torch.Tensor] = None,
                     pre_bias: Optional[torch.Tensor] = None,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` [..., D], optionally fusing a
    residual add and a projection output-bias add. The result (and the
    residual) is ``out_dtype``, x's dtype by default; an f32 ``x`` with a
    bf16 ``out_dtype`` is rounded to bf16 first, as ``x.to(out_dtype)``
    would round it. CPU tensors take :func:`layer_norm_plain` on
    ``x.to(out_dtype)``; CUDA tensors launch the kernel or raise."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return layer_norm_plain(x.to(out_dtype), scale, bias, eps, residual,
                                pre_bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    return _launch(x, scale, bias, eps, residual, pre_bias, out_dtype)


def layer_norm_codes_plain(x, scale, bias, eps, residual=None, pre_bias=None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain version of the codes form: :func:`layer_norm_plain`, then
    ``quantize_activations_i8_plain`` of its output's rows."""
    out = layer_norm_plain(x, scale, bias, eps, residual, pre_bias)
    return (out, *_i8.quantize_activations_i8_plain(
        out.reshape(-1, out.shape[-1])))


def fused_layer_norm_codes(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, *, eps: float,
                           residual: Optional[torch.Tensor] = None,
                           pre_bias: Optional[torch.Tensor] = None,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """:func:`fused_layer_norm`'s codes form: ``(out, codes, sx)`` with
    ``out`` as :func:`fused_layer_norm` gives it and, over its M = numel / D
    rows, ``codes`` [M, Kp] int8 (Kp = D rounded up to 32, a zero tail) and
    ``sx`` [M] f32: the W8A8 activation codes of ``out`` as rounded. CPU
    tensors take :func:`layer_norm_codes_plain` on ``x.to(out_dtype)``;
    CUDA tensors launch the kernel or raise."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return layer_norm_codes_plain(x.to(out_dtype), scale, bias, eps,
                                      residual, pre_bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm_codes: unsupported device "
                         f"{x.device}")
    return _launch(x, scale, bias, eps, residual, pre_bias, out_dtype,
                   codes=True)


fused_layer_norm.launches = 0  # kernel launches, counted where they happen
fused_layer_norm_codes.launches = 0

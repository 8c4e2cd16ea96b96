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

The add form (:func:`fused_add_layer_norm`, for pre-LN blocks:
``modernbert.py``) takes a sublayer's product y (f32, or the stream's
dtype) and the stream x and writes both the new stream ``s = y + x``, y
rounded to the stream's dtype first and the sum rounded to it, and
``LN(s)``, in one pass. Its plain version, :func:`add_layer_norm_plain`,
computes the same bits.

The RMS forms (:func:`rms_norm`, :func:`add_rms_norm`; kernels of their own
in the same source), for DeepSeek-V2's pre-RMSNorm blocks
(``deepseek_v2.py``): ``x · rsqrt(mean(x²) + eps) · scale`` in f32 from
bf16 rows, rounded to bf16, no mean taken out and no bias; the add form
forms the new stream ``s = y + x`` as the LayerNorm's add form does. The
plain form reads rows at a stride (the latent half of a wider row). Their
plain versions are :func:`rms_norm_plain` and :func:`add_rms_norm_plain`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _kernels
from . import int8_matmul as _i8
from .common import counted, round_up

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


@counted
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


@counted
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


def add_layer_norm_plain(y, x, scale, bias, eps):
    """Plain version of the add form: ``s = y.to(x.dtype) + x``, then
    :func:`layer_norm_plain` of s; returns (s, LN(s))."""
    s = y.to(x.dtype) + x
    return s, layer_norm_plain(s, scale, bias, eps)


@counted
def fused_add_layer_norm(y: torch.Tensor, x: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor, *,
                         eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pre-LN step: the new stream ``s = y + x`` (y rounded to x's
    dtype, the sum rounded to it) and ``LN(s)``, both in x's dtype, from
    one launch; y is x's dtype or an f32 product. CPU tensors take
    :func:`add_layer_norm_plain`; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return add_layer_norm_plain(y, x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_add_layer_norm: unsupported device "
                         f"{x.device}")
    d = x.shape[-1]
    fn = _ENTRY.get((y.dtype, x.dtype))
    if fn is None:
        raise TypeError(f"fused_add_layer_norm: {y.dtype} -> {x.dtype} not "
                        "in (f32 -> f32, bf16 -> bf16, f32 -> bf16)")
    if (y.shape != x.shape or y.device != x.device
            or not (y.is_contiguous() and x.is_contiguous())):
        raise ValueError(f"fused_add_layer_norm: y and x must be contiguous "
                         f"{tuple(x.shape)} on {x.device}")
    for name, p in (("scale", scale), ("bias", bias)):
        if (tuple(p.shape) != (d,) or p.dtype != torch.float32
                or p.device != x.device or not p.is_contiguous()):
            raise ValueError(f"fused_add_layer_norm: {name} must be "
                             f"contiguous f32 [{d}] on {x.device}")
    _check_alignment(y, x, None, scale, bias, x.dtype)
    out = torch.empty_like(x)
    s = torch.empty_like(x)
    m = x.numel() // d
    if m == 0:
        return s, out
    fn = fn.replace("layer_norm_", "layer_norm_add_")
    lib = _kernels.library("layer_norm")
    with torch.cuda.device(x.device):
        rc = getattr(lib, fn)(y.data_ptr(), x.data_ptr(), scale.data_ptr(),
                              bias.data_ptr(), out.data_ptr(), s.data_ptr(),
                              m, d, float(eps), _kernels.stream_of(x))
    _kernels.check(rc, fn)
    fused_add_layer_norm.launches += 1
    return s, out


def rms_norm_plain(x, scale, eps):
    """Plain version of the RMS form: ``x · rsqrt(mean(x²) + eps) · scale``
    in f32, rounded to x's dtype."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * r * scale).to(x.dtype)


def add_rms_norm_plain(y, x, scale, eps):
    """Plain version of the RMS add form: ``s = y.to(x.dtype) + x``, then
    :func:`rms_norm_plain` of s; returns (s, RMS(s))."""
    s = y.to(x.dtype) + x
    return s, rms_norm_plain(s, scale, eps)


def _check_rms(name, x, scale, d):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the stream must be bf16, got {x.dtype}")
    if d % 8:
        raise ValueError(f"{name}: D = {d} is not a multiple of 8")
    if (tuple(scale.shape) != (d,) or scale.dtype != torch.float32
            or scale.device != x.device or not scale.is_contiguous()):
        raise ValueError(f"{name}: scale must be contiguous f32 [{d}] on "
                         f"{x.device}")
    for t in (x, scale):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: an operand at 0x{t.data_ptr():x} is "
                             "not 16-byte aligned")


@counted
def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float
             ) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` [M, D] (bf16; rows may lie at a
    stride, a column slice of a wider row) → a new contiguous [M, D]. CPU
    tensors take :func:`rms_norm_plain`; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    if x.dim() != 2 or x.stride(1) != 1 or x.stride(0) % 8:
        raise ValueError("rms_norm: x must be [M, D] with unit column "
                         "stride and a row stride that 8 divides")
    m, d = x.shape
    _check_rms("rms_norm", x, scale, d)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _kernels.library("layer_norm").rms_norm_bf16(
            x.data_ptr(), x.stride(0), scale.data_ptr(), out.data_ptr(), m,
            d, float(eps), _kernels.stream_of(x))
    _kernels.check(rc, "rms_norm_bf16")
    rms_norm.launches += 1
    return out


@counted
def add_rms_norm(y: torch.Tensor, x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pre-RMSNorm step: the new stream ``s = y + x`` (y, a product's
    f32 output, rounded to bf16 first, the sum rounded to bf16) and
    ``RMS(s)``, from one launch. CPU tensors take
    :func:`add_rms_norm_plain`; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(y, x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"add_rms_norm: unsupported device {x.device}")
    d = x.shape[-1]
    if y.dtype != torch.float32:
        raise TypeError(f"add_rms_norm: y must be f32, got {y.dtype}")
    if (y.shape != x.shape or y.device != x.device
            or not (y.is_contiguous() and x.is_contiguous())):
        raise ValueError(f"add_rms_norm: y and x must be contiguous "
                         f"{tuple(x.shape)} on {x.device}")
    _check_rms("add_rms_norm", x, scale, d)
    if y.data_ptr() % 16:
        raise ValueError("add_rms_norm: y is not 16-byte aligned")
    out = torch.empty_like(x)
    s = torch.empty_like(x)
    m = x.numel() // d
    if m == 0:
        return s, out
    with torch.cuda.device(x.device):
        rc = _kernels.library("layer_norm").rms_norm_add_f32_bf16(
            y.data_ptr(), x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            s.data_ptr(), m, d, float(eps), _kernels.stream_of(x))
    _kernels.check(rc, "rms_norm_add_f32_bf16")
    add_rms_norm.launches += 1
    return s, out

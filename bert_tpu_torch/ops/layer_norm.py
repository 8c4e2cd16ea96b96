"""Fused (pre-bias + residual +) LayerNorm: ``LN(x [+ pre_bias] [+ residual])``.

Counterpart of ``bert_tpu/ops/layer_norm.py``. On the H100 the kernel is
``bert_tpu_torch/csrc/layer_norm.cu`` (it replaces the Pallas
``_ln_kernel``, ``_ln_res_kernel`` and ``_ln_res_pb_kernel`` with one
kernel whose residual and pre-bias operands are optional; the source says
what bounds it and how the simple design copes). f32 statistics, biased
variance, ``(x - mean) * rsqrt(var + eps) * scale + bias`` cast to x's
dtype (bert.cpp:806-814 semantics).

:func:`layer_norm_plain` mirrors ``layer_norm_jnp``, what the JAX model runs
on a CPU. Its rounding differs from the kernel's: it adds ``pre_bias`` and
``residual`` in x's dtype before widening to f32, where the kernel (like
the Pallas kernels) widens first and adds in f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels

MAX_D = 1024  # one warp per row, at most 32 values per lane


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


def _launch(x, scale, bias, eps, residual, pre_bias):
    d = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_layer_norm: dtype {x.dtype} not in "
                        "(f32, bf16)")
    if not 0 < d <= MAX_D:
        raise ValueError(f"fused_layer_norm: D={d} outside 1..{MAX_D}")
    if not x.is_contiguous():
        raise ValueError("fused_layer_norm: x must be contiguous")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device
                                 or not residual.is_contiguous()):
        raise ValueError("fused_layer_norm: residual must match x "
                         "(shape, dtype, device, contiguous)")
    for name, p in (("scale", scale), ("bias", bias), ("pre_bias", pre_bias)):
        if p is None and name == "pre_bias":
            continue
        if (tuple(p.shape) != (d,) or p.dtype != torch.float32
                or p.device != x.device or not p.is_contiguous()):
            raise ValueError(f"fused_layer_norm: {name} must be contiguous "
                             f"f32 [{d}] on {x.device}")
    out = torch.empty_like(x)
    m = x.numel() // d
    if m == 0:
        return out
    fn = "layer_norm_f32" if x.dtype == torch.float32 else "layer_norm_bf16"
    lib = _kernels.library("layer_norm")
    with torch.cuda.device(x.device):
        rc = getattr(lib, fn)(
            x.data_ptr(),
            None if residual is None else residual.data_ptr(),
            None if pre_bias is None else pre_bias.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(), m, d,
            float(eps), _kernels.stream_of(x))
    _kernels.check(rc, fn)
    fused_layer_norm.launches += 1
    return out


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, *, eps: float,
                     residual: Optional[torch.Tensor] = None,
                     pre_bias: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` [..., D], optionally fusing a
    residual add and a projection output-bias add. CPU tensors take
    :func:`layer_norm_plain`; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps, residual, pre_bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    return _launch(x, scale, bias, eps, residual, pre_bias)


fused_layer_norm.launches = 0  # kernel launches, counted where they happen

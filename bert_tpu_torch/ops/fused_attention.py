"""Fused masked softmax attention over the raw, head-interleaved QKV output.

Counterpart of ``bert_tpu/ops/fused_attention.py``: qkv ``[B, T, 3D]``
(for head h: lanes ``[3·dh·h, 3·dh·h + dh)`` = q, then k, then v;
bert_tpu_torch/params.py) plus an additive f32 bias — key-side ``[B, T]``
or packed pairwise ``[B, T, T]`` — gives the context ``[B, T, D]`` in the
model's native layout. On the H100 the kernel is
``bert_tpu_torch/csrc/fused_attention.cu`` (it replaces the Pallas
``_fused_attn_kernel``; the source says what bounds it and how its
tensor-core design copes). It streams key tiles with an online softmax, so
it has no compile envelope: :func:`fused_route` sends it every shape whose
head dim
has an instance, and the model sends the rest to the per-(batch, head)
kernel of ``ops/attention.py``.

:func:`attention_plain` is ``_mha_jnp`` applied to the head-interleaved
layout, what the JAX model runs on a CPU. Its rounding differs from the
kernel's: it scales the f32 scores by 1/√dh, where the kernel (like the
Pallas kernel) folds the scale into q in q's dtype; and it normalizes the
probabilities before rounding them to q's dtype, where the kernel rounds
the unnormalized ones and divides the context by their sum.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .attention import _mha_plain

HEAD_DIMS = (32, 64)  # the kernel's template instances


def fused_route(t: int, n_head: int, d_head: int, dtype: torch.dtype,
                pairwise: bool) -> bool:
    """Whether the fused kernel takes this attention (the port's
    ``pick_head_chunk``): true exactly when ``d_head`` has an instance. The
    kernel streams key tiles, so T, the head count, the dtype and the bias
    form set no envelope; they are parameters so that the call reads like
    bert_tpu's."""
    return d_head in HEAD_DIMS


def attention_plain(qkv: torch.Tensor, mask_bias: torch.Tensor, *,
                    n_head: int, d_head: int, scale: float) -> torch.Tensor:
    """Plain version: ``_mha_jnp`` on the head-interleaved layout."""
    b, t, _ = qkv.shape
    q5 = qkv.reshape(b, t, n_head, 3, d_head).permute(0, 2, 3, 1, 4)
    ctx = _mha_plain(q5[:, :, 0], q5[:, :, 1], q5[:, :, 2], mask_bias, scale)
    return ctx.permute(0, 2, 1, 3).reshape(b, t, n_head * d_head)


def _check_alignment(qkv: torch.Tensor, mask_bias: torch.Tensor) -> None:
    """The kernel (either dtype) copies qkv rows by 16 bytes and reads the
    bias by 8: raise where an operand is not aligned for that; never fall
    back."""
    for name, t, need in (("qkv", qkv, 16), ("mask_bias", mask_bias, 8)):
        if t.data_ptr() % need:
            raise ValueError(f"fused_qkv_attention: {name} at "
                             f"0x{t.data_ptr():x} is not {need}-byte "
                             "aligned")


def _launch(qkv, mask_bias, n_head, d_head, scale):
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * n_head * d_head:
        raise ValueError(f"fused_qkv_attention: qkv {tuple(qkv.shape)} is "
                         f"not [B, T, 3·{n_head}·{d_head}]")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_qkv_attention: dtype {qkv.dtype} not in "
                        "(f32, bf16)")
    if d_head not in HEAD_DIMS:
        raise ValueError(f"fused_qkv_attention: head dim {d_head} not in "
                         f"{HEAD_DIMS}")
    b, t, _ = qkv.shape
    pairwise = mask_bias.dim() == 3
    want = (b, t, t) if pairwise else (b, t)
    if (tuple(mask_bias.shape) != want or mask_bias.dtype != torch.float32
            or mask_bias.device != qkv.device):
        raise ValueError(f"fused_qkv_attention: mask_bias must be f32 "
                         f"{want} on {qkv.device}, got {mask_bias.dtype} "
                         f"{tuple(mask_bias.shape)}")
    if not (qkv.is_contiguous() and mask_bias.is_contiguous()):
        raise ValueError("fused_qkv_attention: operands must be contiguous")
    _check_alignment(qkv, mask_bias)
    out = torch.empty((b, t, n_head * d_head), dtype=qkv.dtype,
                      device=qkv.device)
    if b == 0 or t == 0:
        return out
    fn = ("fused_attention_f32" if qkv.dtype == torch.float32
          else "fused_attention_bf16")
    lib = _kernels.library("fused_attention")
    with torch.cuda.device(qkv.device):
        rc = getattr(lib, fn)(
            qkv.data_ptr(), mask_bias.data_ptr(), out.data_ptr(), b, t,
            n_head, d_head, int(pairwise), float(scale),
            _kernels.stream_of(qkv))
    _kernels.check(rc, fn)
    fused_qkv_attention.launches += 1
    return out


def fused_qkv_attention(qkv: torch.Tensor, mask_bias: torch.Tensor, *,
                        n_head: int, d_head: int, scale: float
                        ) -> torch.Tensor:
    """qkv [B, T, 3D] (head-interleaved) + additive bias ([B, T] key-side
    or [B, T, T] pairwise) → context [B, T, D]. CPU tensors take
    :func:`attention_plain`; CUDA tensors launch the kernel or raise."""
    if qkv.device.type == "cpu":
        return attention_plain(qkv, mask_bias, n_head=n_head,
                               d_head=d_head, scale=scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention: unsupported device "
                         f"{qkv.device}")
    return _launch(qkv, mask_bias, n_head, d_head, scale)


fused_qkv_attention.launches = 0  # kernel launches, counted where they happen

"""Per-(batch, head) masked softmax attention over ``[B, H, T, dh]``.

Counterpart of ``bert_tpu/ops/attention.py`` with its public API,
``multi_head_attention(q, k, v, mask_bias, *, scale)``. On the H100 the
kernel is ``bert_tpu_torch/csrc/attention.cu`` (it replaces the Pallas
``_mha_kernel``). It takes contiguous f32 or bf16 operands of any head dim
and an f32 bias, key-side ``[B, T]`` or pairwise ``[B, T, T]`` — the
Pallas kernel had only the key-side form, and bert_tpu sends pairwise bias
to ``_mha_jnp``; on the card the port has no plain path, so the kernel
takes both.

What bounds the kernel is operations: the scores grow with T², and
normalising p before it is rounded walks the keys twice. Every instance
runs both products (q·kᵀ twice, p·v once) on the tensor cores
(``mma.sync``) over 64-key tiles copied by ``cp.async``. bf16 takes one
bf16 product; f32 takes bert_tpu's ``Precision.HIGHEST`` as the TPU's
matrix unit does, six bf16 products of operands split three ways
(``testing.matmul_bf16x6`` writes the same arithmetic out in PyTorch),
each key tile's products summed in a fresh accumulator and added in IEEE
f32. So what is left is the issue of the softmax around each score, of
the tiles' copies and, in f32, of the split. Head dims to 128 take one
instance each for DH 32, 64 and 128; head dims above 128 (no
configuration of the repo has them) take one more in both types, q·kᵀ
summed over the head dim in 64-lane chunks and the context in blocks of
128 columns. The source's note gives the numbers. Rows are copied in the
widest unit their byte stride allows: bf16 by 16 bytes where dh % 8 ==
0, by 4 where dh is even (rubert-tiny2's 26), element by element for odd
dh; f32 by 16 where dh % 4 == 0, by 8 where dh is even, by 4 otherwise.
An operand not aligned for its path raises (:func:`_check_alignment`).

:func:`_mha_plain` is ``_mha_jnp`` in torch, and the kernel rounds as both
do: f32 scores multiplied by ``scale``, then the bias added; an f32
softmax normalised before p is rounded to v's type; ``p @ v`` summed in
f32 and cast once. (The fused QKV kernel rounds otherwise: it folds the
scale into q and defers the normalisation.)
"""

from __future__ import annotations

import torch

from .. import _kernels
from .common import counted


def _bias4(mask_bias: torch.Tensor) -> torch.Tensor:
    """[B, T] key-side → [B, 1, 1, T]; [B, T, T] pairwise → [B, 1, T, T]."""
    if mask_bias.dim() == 2:
        return mask_bias[:, None, None, :]
    if mask_bias.dim() == 3:
        return mask_bias[:, None, :, :]
    raise ValueError(f"mask_bias rank {mask_bias.dim()} not in (2, 3)")


def _mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask_bias: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version: ``_mha_jnp`` on [B, H, T, dh] operands."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * scale + _bias4(mask_bias)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _check_alignment(q, k, v, mask_bias) -> None:
    """The kernel copies rows of dh elements in the widest unit their byte
    stride allows (f32: 16, 8 or 4 bytes; bf16: 16, 4 or 2), and reads the
    bias by 8 bytes where T is even: raise where q, k, v or the bias is not
    aligned for the path its shape takes; never fall back."""
    dh, t = q.shape[-1], q.shape[-2]
    if q.dtype == torch.float32:
        need = 16 if dh % 4 == 0 else 8 if dh % 2 == 0 else 4
    else:
        need = 16 if dh % 8 == 0 else 4 if dh % 2 == 0 else 2
    for name, x, n in (("q", q, need), ("k", k, need), ("v", v, need),
                       ("mask_bias", mask_bias, 8 if t % 2 == 0 else 4)):
        if x.data_ptr() % n:
            raise ValueError(f"multi_head_attention: {name} at "
                             f"0x{x.data_ptr():x} is not {n}-byte aligned "
                             f"({q.dtype}, head dim {dh}, T {t})")


def _launch(q, k, v, mask_bias, scale):
    b, h, t, dh = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"multi_head_attention: dtype {q.dtype} not in "
                        "(f32, bf16)")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"multi_head_attention: {name} must match q "
                             f"(shape, dtype, device), got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    pairwise = mask_bias.dim() == 3
    want = (b, t, t) if pairwise else (b, t)
    if (tuple(mask_bias.shape) != want or mask_bias.dtype != torch.float32
            or mask_bias.device != q.device):
        raise ValueError(f"multi_head_attention: mask_bias must be f32 "
                         f"{want} on {q.device}, got {mask_bias.dtype} "
                         f"{tuple(mask_bias.shape)}")
    if not all(x.is_contiguous() for x in (q, k, v, mask_bias)):
        raise ValueError("multi_head_attention: operands must be contiguous")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _check_alignment(q, k, v, mask_bias)
    fn = "mha_f32" if q.dtype == torch.float32 else "mha_bf16"
    lib = _kernels.library("attention")
    with torch.cuda.device(q.device):
        rc = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_bias.data_ptr(),
            out.data_ptr(), b, h, t, dh, int(pairwise), float(scale),
            _kernels.stream_of(q))
    _kernels.check(rc, fn)
    multi_head_attention.launches += 1
    return out


@counted
def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask_bias: torch.Tensor, *, scale: float
                         ) -> torch.Tensor:
    """Masked MHA over [B, H, T, d_head] tensors; ``mask_bias`` is additive
    — [B, T] key-side (0 for real tokens, NEG_INF for padding) or [B, T, T]
    pairwise (packed block-diagonal rows). CPU tensors take
    :func:`_mha_plain`; CUDA tensors launch the kernel or raise."""
    if q.dim() != 4:
        raise ValueError(f"multi_head_attention: q {tuple(q.shape)} is not "
                         "[B, H, T, dh]")
    if q.device.type == "cpu":
        return _mha_plain(q, k, v, mask_bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"multi_head_attention: unsupported device "
                         f"{q.device}")
    return _launch(q, k, v, mask_bias, scale)

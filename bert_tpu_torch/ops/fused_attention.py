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

ModernBERT (``modernbert.py``) rotates q and k first with
:func:`rope_qkv` (RoPE, rotate-half, from the cos and sin tables [P, dh/2]
of :func:`rope_tables` and optional int32 ``positions`` [B, T]): on the
card one pass of its own kernel (``rope_qkv_*``), in place; then its
global layers take the kernel above (in bf16 at T >= 1,024 its long-T
form, ``fused_attention_wgmma_bf16``: :func:`wgmma_route`, counted apart
by ``fused_qkv_attention.wgmma``), and its local layers ``window`` w >
0: only the keys with |i - j| <= w, in a kernel of its own
(``fused_attention_band_*``, an instance at dh 64,
:data:`BAND_HEAD_DIMS`) that visits only the key tiles the band meets.
:func:`rope_qkv_plain` rotates in f32 (each product and the sum rounded,
as the kernel does) and rounds to qkv's dtype; :func:`attention_plain`
masks the keys outside the band to -inf (the diagonal always stays, so no
row is empty).
"""

from __future__ import annotations

import torch

from .. import _kernels
from .attention import _mha_plain
from .common import Count, counted

HEAD_DIMS = (32, 64)  # the kernel's template instances
BAND_HEAD_DIMS = (64,)  # the band instances
WGMMA_MIN_T = 1024  # the long-T form's shortest T (wgmma_route)


def fused_route(d_head: int) -> bool:
    """Whether the fused kernel takes an attention of head dim ``d_head``:
    exactly when it has an instance. The kernel streams key tiles, so T,
    the head count, the dtype and the bias form set no envelope."""
    return d_head in HEAD_DIMS


def wgmma_route(dtype: torch.dtype, t: int, d_head: int, pairwise: bool,
                window: int) -> bool:
    """Whether a launch of T = ``t`` takes the kernel's long-T form
    (``fused_attention_wgmma_bf16``: wgmma on TMA-fed key tiles, built for
    ModernBERT's global layers): bf16, head dim 64, the key-side bias, no
    band, T >= :data:`WGMMA_MIN_T`. Every other launch keeps its instance.
    f32, packed rows, the band and dh 32 have no long-T form. T <= 512 (all
    of BERT and MiniLM) stays on the mma.sync instance by choice, not by
    measurement: called by its entry point, the long-T form ran faster at
    32 x 512 and 128 x 256 too (PERF.md, "B6"), and the cut at 1,024 is
    where ModernBERT's batches start, not a measured crossover."""
    return (dtype == torch.bfloat16 and d_head == 64 and not pairwise
            and not window and t >= WGMMA_MIN_T)


def rope_tables(theta: float, d_head: int, n_pos: int, device=None):
    """RoPE's (cos, sin) [n_pos, d_head/2] f32: angle p · θ^(−2i/d_head)
    for position p and lane i, as transformers' default rotary embedding
    forms it (inv_freq in f32, one f32 product)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.int64,
                                             device=device).float() / d_head))
    freqs = torch.arange(n_pos, device=device).float()[:, None] * inv_freq
    return freqs.cos().contiguous(), freqs.sin().contiguous()


def rope_qkv_plain(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   positions=None, *, n_head: int, d_head: int
                   ) -> torch.Tensor:
    """Rotate-half RoPE of q and k of qkv [B, T, 3D] (head-interleaved) at
    ``positions`` [B, T] (None: 0..T-1), in f32, rounded to qkv's dtype; v
    as it is. A new tensor."""
    b, t, _ = qkv.shape
    half = d_head // 2
    if positions is None:
        c, s = cos[:t][None, :, None, None], sin[:t][None, :, None, None]
    else:
        p = positions.long()
        c, s = cos[p][:, :, None, None], sin[p][:, :, None, None]
    x = qkv.reshape(b, t, n_head, 3, d_head)
    qk = x[:, :, :, :2].float()
    x1, x2 = qk[..., :half], qk[..., half:]
    rot = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([rot.to(qkv.dtype), x[:, :, :, 2:]],
                     dim=3).reshape(b, t, 3 * n_head * d_head)


@counted
def rope_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
             positions=None, *, n_head: int, d_head: int) -> torch.Tensor:
    """:func:`rope_qkv_plain`'s rotation. CUDA tensors: the ``rope_qkv_*``
    kernel rotates qkv in place and returns it; CPU tensors take
    :func:`rope_qkv_plain` (a new tensor)."""
    if qkv.device.type == "cpu":
        return rope_qkv_plain(qkv, cos, sin, positions, n_head=n_head,
                              d_head=d_head)
    if qkv.device.type != "cuda":
        raise ValueError(f"rope_qkv: unsupported device {qkv.device}")
    b, t, width = qkv.shape
    if width != 3 * n_head * d_head or d_head % 16:
        raise ValueError(f"rope_qkv: qkv {tuple(qkv.shape)} is not [B, T, "
                         f"3·{n_head}·{d_head}] with a head dim that 16 "
                         "divides")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rope_qkv: dtype {qkv.dtype} not in (f32, bf16)")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("rope_qkv: qkv must be contiguous and 16-byte "
                         "aligned")
    for name, tab in (("cos", cos), ("sin", sin)):
        if (tab.dim() != 2 or tab.shape[1] != d_head // 2
                or tab.shape[0] < t or tab.dtype != torch.float32
                or tab.device != qkv.device or not tab.is_contiguous()):
            raise ValueError(f"rope_qkv: {name} must be contiguous f32 "
                             f"[P >= {t}, {d_head // 2}] on {qkv.device}, "
                             f"got {tab.dtype} {tuple(tab.shape)}")
    if positions is not None and (
            tuple(positions.shape) != (b, t)
            or positions.dtype != torch.int32
            or positions.device != qkv.device
            or not positions.is_contiguous()):
        raise ValueError(f"rope_qkv: positions must be contiguous int32 "
                         f"{(b, t)} on {qkv.device}")
    if b == 0 or t == 0:
        return qkv
    fn = f"rope_qkv_{'f32' if qkv.dtype == torch.float32 else 'bf16'}"
    with torch.cuda.device(qkv.device):
        rc = getattr(_kernels.library("fused_attention"), fn)(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            None if positions is None else positions.data_ptr(), b, t,
            n_head, d_head, _kernels.stream_of(qkv))
    _kernels.check(rc, fn)
    rope_qkv.launches += 1
    return qkv


def band_bias(t: int, window: int, device=None) -> torch.Tensor:
    """[T, T] f32: 0 where |i - j| <= window, -inf elsewhere."""
    i = torch.arange(t, device=device)
    far = (i[:, None] - i[None, :]).abs() > window
    return torch.zeros((t, t), device=device).masked_fill(far, float("-inf"))


def attention_plain(qkv: torch.Tensor, mask_bias: torch.Tensor, *,
                    n_head: int, d_head: int, scale: float, window: int = 0
                    ) -> torch.Tensor:
    """Plain version: ``_mha_jnp`` on the head-interleaved layout; with
    ``window`` > 0 the band."""
    b, t, _ = qkv.shape
    q5 = qkv.reshape(b, t, n_head, 3, d_head).permute(0, 2, 3, 1, 4)
    q, k, v = q5[:, :, 0], q5[:, :, 1], q5[:, :, 2]
    if window > 0:
        if mask_bias.dim() == 2:
            mask_bias = mask_bias[:, None, :]
        mask_bias = mask_bias + band_bias(t, window, qkv.device)
    ctx = _mha_plain(q, k, v, mask_bias, scale)
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


def _launch(qkv, mask_bias, n_head, d_head, scale, window=0, tiles=None):
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
    if window and d_head not in BAND_HEAD_DIMS:
        raise ValueError(f"fused_qkv_attention: band instances exist for "
                         f"head dims {BAND_HEAD_DIMS}, not {d_head}")
    out = torch.empty((b, t, n_head * d_head), dtype=qkv.dtype,
                      device=qkv.device)
    if b == 0 or t == 0:
        return out
    dt = "f32" if qkv.dtype == torch.float32 else "bf16"
    long_t = wgmma_route(qkv.dtype, t, d_head, pairwise, window)
    lib = _kernels.library("fused_attention")
    with torch.cuda.device(qkv.device):
        if long_t:
            fn = "fused_attention_wgmma_bf16"
            rc = getattr(lib, fn)(
                qkv.data_ptr(), mask_bias.data_ptr(), out.data_ptr(), b, t,
                n_head, d_head, float(scale), _kernels.stream_of(qkv))
        elif not window:
            fn = f"fused_attention_{dt}"
            rc = getattr(lib, fn)(
                qkv.data_ptr(), mask_bias.data_ptr(), out.data_ptr(), b, t,
                n_head, d_head, int(pairwise), float(scale),
                _kernels.stream_of(qkv))
        else:
            fn = f"fused_attention_band_{dt}"
            rc = getattr(lib, fn)(
                qkv.data_ptr(), mask_bias.data_ptr(), out.data_ptr(), b, t,
                n_head, d_head, int(pairwise), int(window), float(scale),
                None if tiles is None else tiles.data_ptr(),
                _kernels.stream_of(qkv))
    _kernels.check(rc, fn)
    fused_qkv_attention.launches += 1
    if long_t:
        fused_qkv_attention.wgmma.launches += 1
    return out


@counted
def fused_qkv_attention(qkv: torch.Tensor, mask_bias: torch.Tensor, *,
                        n_head: int, d_head: int, scale: float,
                        window: int = 0, tiles=None) -> torch.Tensor:
    """qkv [B, T, 3D] (head-interleaved) + additive bias ([B, T] key-side
    or [B, T, T] pairwise) → context [B, T, D]. ``window`` > 0 attends over
    |i - j| <= window only (the band kernel, which adds the key tiles its
    blocks visit to ``tiles``, an int32 [1] on the card, where given). CPU
    tensors take :func:`attention_plain`; CUDA tensors launch the kernel or
    raise."""
    if qkv.device.type == "cpu":
        return attention_plain(qkv, mask_bias, n_head=n_head,
                               d_head=d_head, scale=scale, window=window)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention: unsupported device "
                         f"{qkv.device}")
    return _launch(qkv, mask_bias, n_head, d_head, scale, window, tiles)


# of fused_qkv_attention's launches, the long-T form's (wgmma_route)
fused_qkv_attention.wgmma = counted(Count("fused_qkv_attention.wgmma"))

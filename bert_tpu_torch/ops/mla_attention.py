"""DeepSeek-V2's latent attention (MLA) in its expanded prefill form: the
RoPE pass over the rope lanes of q and the shared rope key, and a causal
attention of q·k width 192 (128 "nope" + 64 rope lanes) and v width 128.

The kernels are ``bert_tpu_torch/csrc/mla_attention.cu``; they replace no
TPU kernel (the JAX package has neither causal nor latent attention), and
the source says what bounds them and how their design copes. The operands
stay where the model's products leave them (``deepseek_v2.py``):

    q   [M, H·192]      head h's lanes at h·192: nope, then rope
    kva [M, rank + 64]  the latent c, then the rope key kr (one a token)
    kvb [M, H·256]      head h's k_nope at h·256, its v at h·256 + 128

with M = B·T rows of T tokens. Head h's key is [k_nope_h | kr]. The rope
lanes were de-interleaved at load, so RoPE is rotate-half over them.
:func:`rope_mla_plain` and :func:`causal_attention_plain` are the plain
versions, in f32, rounded to the operands' dtype.

:func:`yarn_inv_freq` is YaRN's inverse frequencies (transformers'
``_compute_yarn_parameters``, the published ``modeling_deepseek.py``'s),
for ``fused_attention.rope_tables``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import _kernels
from .common import counted

NOPE, ROPE, DV = 128, 64, 128  # the kernel's widths


def yarn_inv_freq(dim: int, base: float, factor: float,
                  original_positions: int, beta_fast: float = 32.0,
                  beta_slow: float = 1.0, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies [dim/2] f32, computed as transformers'
    ``_compute_yarn_parameters`` computes them (truncated correction
    range); factor ≤ 1 gives plain RoPE's ``base^(-2i/dim)``."""
    pos_freqs = base ** (torch.arange(0, dim, 2, device=device).to(
        dtype=torch.float) / dim)
    extrapolation = 1.0 / pos_freqs
    if factor <= 1:
        return extrapolation

    def corr(rotations):
        return (dim * math.log(original_positions
                               / (rotations * 2 * math.pi))
                ) / (2 * math.log(base))

    low = max(math.floor(corr(beta_fast)), 0)
    high = min(math.ceil(corr(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    extra = 1 - ramp
    interpolation = 1.0 / (factor * pos_freqs)
    return interpolation * (1 - extra) + extrapolation * extra


def rope_mla_plain(q: torch.Tensor, kva: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, *, t: int, n_head: int, rank: int,
                   nope: int = NOPE, rope: int = ROPE
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate-half RoPE of each head's ``rope`` lanes of q (after its
    ``nope`` ones) and of kr, token t of each row of ``t`` tokens at
    position t, in f32, rounded to the operands' dtype; new tensors."""
    m = q.shape[0]
    p = torch.arange(m, device=cos.device) % t
    c, s = cos[p], sin[p]  # [M, rope/2]
    half = rope // 2

    def rot(x):  # x [M, ..., 64]
        xf = x.float()
        shape = (m,) + (1,) * (x.dim() - 2) + (half,)
        cc, ss = c.reshape(shape), s.reshape(shape)
        x1, x2 = xf[..., :half], xf[..., half:]
        return torch.cat([x1 * cc - x2 * ss, x2 * cc + x1 * ss],
                         dim=-1).to(x.dtype)

    q3 = q.reshape(m, n_head, nope + rope)
    q_out = torch.cat([q3[..., :nope], rot(q3[..., nope:])], dim=-1)
    kva_out = torch.cat([kva[:, :rank], rot(kva[:, rank:rank + rope]),
                         kva[:, rank + rope:]], dim=-1)
    return q_out.reshape(q.shape), kva_out


@counted
def rope_mla(q: torch.Tensor, kva: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor, *, t: int, n_head: int, rank: int,
             nope: int = NOPE, rope: int = ROPE
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rope_mla_plain`'s rotation. CUDA tensors (bf16): the
    ``rope_mla_bf16`` kernel (128 nope and 64 rope lanes) rotates q and kva
    in place and returns them; CPU tensors take :func:`rope_mla_plain`."""
    if q.device.type == "cpu":
        return rope_mla_plain(q, kva, cos, sin, t=t, n_head=n_head,
                              rank=rank, nope=nope, rope=rope)
    if q.device.type != "cuda":
        raise ValueError(f"rope_mla: unsupported device {q.device}")
    if (nope, rope) != (NOPE, ROPE):
        raise ValueError(f"rope_mla: the kernel takes {NOPE} + {ROPE} "
                         f"lanes a head, not {nope} + {rope}")
    m = q.shape[0]
    if (q.dim() != 2 or q.shape[1] != n_head * (NOPE + ROPE)
            or kva.dim() != 2 or kva.shape[0] != m
            or kva.shape[1] < rank + ROPE or m % t):
        raise ValueError(f"rope_mla: q {tuple(q.shape)} and kva "
                         f"{tuple(kva.shape)} are not [B·{t}, {n_head}·192] "
                         f"and [B·{t}, >= {rank} + 64]")
    if q.dtype != torch.bfloat16 or kva.dtype != q.dtype:
        raise TypeError(f"rope_mla: the kernel takes bf16, got {q.dtype}, "
                        f"{kva.dtype}")
    if not (q.is_contiguous() and kva.is_contiguous()):
        raise ValueError("rope_mla: q and kva must be contiguous")
    for name, tab in (("cos", cos), ("sin", sin)):
        if (tab.dim() != 2 or tab.shape[1] != ROPE // 2
                or tab.dtype != torch.float32 or tab.device != q.device
                or not tab.is_contiguous()):
            raise ValueError(f"rope_mla: {name} must be contiguous f32 [P, "
                             f"{ROPE // 2}] on {q.device}")
    if cos.shape[0] < t:
        raise ValueError(f"rope_mla: tables hold {cos.shape[0]} positions, "
                         f"fewer than T = {t}")
    if m == 0:
        return q, kva
    with torch.cuda.device(q.device):
        rc = _kernels.library("mla_attention").rope_mla_bf16(
            q.data_ptr(), kva.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            m // t, t, n_head, q.shape[1], kva.shape[1], rank,
            _kernels.stream_of(q))
    _kernels.check(rc, "rope_mla_bf16")
    rope_mla.launches += 1
    return q, kva


def causal_attention_plain(q: torch.Tensor, kva: torch.Tensor,
                           kvb: torch.Tensor, *, t: int, n_head: int,
                           rank: int, scale: float, nope: int = NOPE,
                           rope: int = ROPE, dv: int = DV) -> torch.Tensor:
    """Plain version: per (row, head), softmax(scale · q·kᵀ + causal) · v in
    f32 with k = [k_nope | kr], rounded to q's dtype → [M, H·dv]."""
    m = q.shape[0]
    b = m // t
    qh = q.float().reshape(b, t, n_head, nope + rope).transpose(1, 2)
    kv = kvb.float().reshape(b, t, n_head, nope + dv).transpose(1, 2)
    kr = kva.float()[:, rank:rank + rope].reshape(b, 1, t, rope)
    k = torch.cat([kv[..., :nope], kr.expand(b, n_head, t, rope)], dim=-1)
    v = kv[..., nope:]
    s = (qh @ k.transpose(-1, -2)) * scale
    i = torch.arange(t, device=q.device)
    s = s.masked_fill(i[None, :] > i[:, None], float("-inf"))
    ctx = torch.softmax(s, dim=-1) @ v  # [b, H, t, dv]
    return ctx.transpose(1, 2).reshape(m, n_head * dv).to(q.dtype)


@counted
def causal_attention(q: torch.Tensor, kva: torch.Tensor, kvb: torch.Tensor,
                     *, t: int, n_head: int, rank: int, scale: float,
                     nope: int = NOPE, rope: int = ROPE, dv: int = DV
                     ) -> torch.Tensor:
    """The causal latent attention of rows of ``t`` tokens → [M, H·dv] in
    q's dtype. CPU tensors take :func:`causal_attention_plain`; CUDA
    tensors (bf16, 128 + 64 q·k lanes and 128 v lanes a head) launch the
    kernel or raise."""
    if q.device.type == "cpu":
        return causal_attention_plain(q, kva, kvb, t=t, n_head=n_head,
                                      rank=rank, scale=scale, nope=nope,
                                      rope=rope, dv=dv)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention: unsupported device {q.device}")
    if (nope, rope, dv) != (NOPE, ROPE, DV):
        raise ValueError(f"causal_attention: the kernel takes {NOPE} + "
                         f"{ROPE} q·k lanes and {DV} v lanes a head")
    if any(x.dtype != torch.bfloat16 for x in (q, kva, kvb)):
        raise TypeError("causal_attention: the kernel takes bf16 operands")
    m = q.shape[0]
    if (q.dim() != 2 or q.shape[1] != n_head * (NOPE + ROPE)
            or kvb.shape != (m, n_head * (NOPE + DV))
            or kva.dim() != 2 or kva.shape[0] != m
            or kva.shape[1] < rank + ROPE or m % t or rank % 8):
        raise ValueError(f"causal_attention: q {tuple(q.shape)}, kva "
                         f"{tuple(kva.shape)}, kvb {tuple(kvb.shape)} at T "
                         f"{t}, {n_head} heads, rank {rank}")
    for name, x in (("q", q), ("kva", kva), ("kvb", kvb)):
        if not x.is_contiguous() or x.data_ptr() % 16 or x.shape[1] % 8:
            raise ValueError(f"causal_attention: {name} must be contiguous "
                             "and 16-byte aligned, its rows a multiple of 8")
    out = torch.empty((m, n_head * DV), dtype=q.dtype, device=q.device)
    if m == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _kernels.library("mla_attention").causal_mla_attention_bf16(
            q.data_ptr(), kva.data_ptr(), kvb.data_ptr(), out.data_ptr(),
            m // t, t, n_head, q.shape[1], kva.shape[1], kvb.shape[1], rank,
            float(scale), _kernels.stream_of(q))
    _kernels.check(rc, "causal_mla_attention_bf16")
    causal_attention.launches += 1
    return out


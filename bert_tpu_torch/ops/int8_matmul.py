"""W8A8 matmul: per-column int8 weights × per-row int8 activations on the
H100's int8 tensor cores.

Counterpart of ``bert_tpu/ops/int8_matmul.py``, which is XLA on purpose
(no Pallas kernel there). On the H100 the path is two hand-written
kernels in ``bert_tpu_torch/csrc/int8_matmul.cu`` (the source says what
bounds each and how its design copes):

  * ``quantize_rows_i8``: x[M, K] (f32 or bf16) → per-row symmetric int8
    codes and ``sx[M]`` f32 (``quantize_activations_i8``), in one read of
    the row;
  * ``int8_matmul``: persistent warp-specialised blocks, TMA tile loads
    and s8 × s8 → s32 ``wgmma``, then ``p = (float(acc) · sx[m]) · sw[n]``
    in f32 and one of three epilogues: (a) p itself, an f32 [M, N]; (b) p
    rounded to ``out_dtype`` (f32 or bf16), plus an optional bias in that
    dtype, rounded again: the cast and bias add that ``dense`` would
    otherwise launch after the product, bit for bit (``int8_matmul``,
    ``int8_matmul_codes``); (c) form (b), then GELU as ``F.gelu`` computes
    it, rounded to ``out_dtype`` (``int8_matmul_gelu``): FFN-up's product
    and activation in one launch.

The LayerNorm's codes form (``ops/layer_norm.py``) writes the codes of its
own rounded output, so the QKV and FFN-up products take codes from their
producers and launch no quantization of their own (``model.py``).

The arithmetic is exact by construction, so the kernels equal their plain
versions, and bert_tpu, bit for bit (finite inputs): the int32 sum is
exact, the epilogue is two f32 products, and the codes are a round half
to even of an f32 product, from an IEEE division for ``sx`` and for its
reciprocal.

Layouts. The host weight is bert_tpu's :class:`Int8Tensor`: ``w_i8[K, N]``
int8 and ``scale[N]`` f32 (``W ≈ w_i8 · scale``). On a device it becomes an
:class:`Int8Weight`: codes ``[N, Kp]`` with K contiguous, zero padded to
``Kp = ceil(K / 32) · 32``, once at load. ``wgmma`` takes 8-bit operands
only K-major, A and B alike, so the weight is stored transposed. The
activation codes share the padded row stride
(:func:`quantize_activations_i8` returns ``[M, Kp]`` with a zero tail), a
multiple of 16 bytes as TMA requires even at K = 312 or 600; zero codes
add nothing to an exact sum.

Plain versions (:func:`quantize_activations_i8_plain`,
:func:`int8_matmul_plain`) follow bert_tpu op for op. torch has no integer
matmul on CUDA, so the plain product multiplies the codes in f64, exact
while K · 127² < 2^53 (f32 would not be: K · 127² passes 2^24 at K =
1,041). The wrappers take the plain version only for a CPU tensor; on a
CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels
from .common import counted, round_up

KP_ALIGN = 32   # the s8 wgmma's depth: codes rows are padded to a multiple
# the largest K whose int32 sum cannot overflow: K · 127² ≤ 2^31 - 1
MAX_K = (2**31 - 1) // (127 * 127)


@dataclass
class Int8Tensor:
    """Per-column symmetric int8 weight for a logical ``W[K, N]`` matmul
    (bert_tpu's host layout): ``w_i8[..., K, N]`` int8 codes, ``scale[...,
    N]`` f32, ``W ≈ w_i8 · scale``."""

    w_i8: np.ndarray
    scale: np.ndarray

    @property
    def shape(self) -> Tuple[int, int]:
        """The logical ``(K, N)`` (a stacked tree's last two axes)."""
        return tuple(self.w_i8.shape[-2:])

    @property
    def n(self) -> int:
        return self.w_i8.shape[-1]


@dataclass
class Int8Weight:
    """An :class:`Int8Tensor` on a device, in the kernel's layout:
    ``w_nk[..., N, Kp]`` int8 (K contiguous, zero padded to a multiple of
    32), ``scale[..., N]`` f32, and the logical K."""

    w_nk: torch.Tensor
    scale: torch.Tensor
    k: int

    @property
    def n(self) -> int:
        return self.w_nk.shape[-2]

    @property
    def kp(self) -> int:
        return self.w_nk.shape[-1]


def quantize_w8(w_kn: np.ndarray) -> Int8Tensor:
    """Dense W[..., K, N] → per-column symmetric int8 (columns = last
    axis); bert_tpu's numpy calls, so the same bits."""
    w = np.asarray(w_kn, dtype=np.float32)
    amax = np.abs(w).max(axis=-2, keepdims=True)  # [..., 1, N]
    scale = amax / 127.0
    inv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
    codes = np.clip(np.rint(w * inv), -127, 127).astype(np.int8)
    return Int8Tensor(w_i8=codes, scale=scale.squeeze(-2).astype(np.float32))


def dequantize_w8(it: Int8Tensor) -> np.ndarray:
    scale = np.asarray(it.scale, np.float32)
    return np.asarray(it.w_i8, np.float32) * scale[..., None, :]


def to_device(it: Int8Tensor, device) -> Int8Weight:
    """Host ``[..., K, N]`` codes → the kernel's ``[..., N, Kp]`` layout on
    ``device`` (K contiguous, zero padded); scales as f32."""
    codes = np.asarray(it.w_i8, np.int8)
    k = codes.shape[-2]
    kp = round_up(k, KP_ALIGN)
    w_nk = np.zeros((*codes.shape[:-2], codes.shape[-1], kp), np.int8)
    w_nk[..., :k] = np.swapaxes(codes, -1, -2)
    return Int8Weight(
        w_nk=torch.from_numpy(w_nk).to(device),
        scale=torch.from_numpy(np.array(it.scale, np.float32)).to(device),
        k=k)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def quantize_activations_i8_plain(x: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x[M, K] (f32 or bf16) → (codes [M, Kp] int8 with a zero tail, sx [M]
    f32): bert_tpu's ``quantize_activations_i8`` op for op. The divisions
    take tensor divisors, which torch divides exactly on every device (a
    scalar divisor may become a multiplication by its reciprocal)."""
    m, k = x.shape
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    sx = amax / torch.full_like(amax, 127.0)
    live = sx > 0
    inv = torch.where(live, torch.ones_like(sx) / torch.where(
        live, sx, torch.ones_like(sx)), torch.zeros_like(sx))
    codes = torch.clamp(torch.round(xf * inv[:, None]), -127, 127)
    out = torch.zeros((m, round_up(k, KP_ALIGN)), dtype=torch.int8,
                      device=x.device)
    out[:, :k] = codes.to(torch.int8)
    return out, sx


def _epilogue(acc: torch.Tensor, sx: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """The f32 epilogue, ``(float(acc) · sx[:, None]) · sw[None, :]``."""
    return acc.float() * sx[:, None] * scale[None, :]


def int8_matmul_codes_plain(codes: torch.Tensor, sx: torch.Tensor,
                            w: Int8Weight,
                            bias: Optional[torch.Tensor] = None,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Plain version of the product on padded codes: the codes meet in
    f64 (exact: every partial sum is an integer under 2^53), the f32
    epilogue, ``.to(out_dtype)``, then ``+ bias`` (already in
    ``out_dtype``) where one is given: what bert_tpu's ``dense`` does
    after its ``int8_matmul``."""
    acc = torch.matmul(codes.double(), w.w_nk.double().transpose(-1, -2))
    y = _epilogue(acc, sx, w.scale).to(out_dtype)
    return y if bias is None else y + bias.to(out_dtype)


def int8_matmul_plain(x: torch.Tensor, w: Int8Weight,
                      bias: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: ``x[M, K] @ (w_i8 · scale)[K, N]`` as bert_tpu's
    ``int8_matmul`` computes it (x quantized per row), then
    :func:`int8_matmul_codes_plain`."""
    codes, sx = quantize_activations_i8_plain(x)
    return int8_matmul_codes_plain(codes, sx, w, bias, out_dtype)


def int8_matmul_gelu_plain(codes: torch.Tensor, sx: torch.Tensor,
                           w: Int8Weight,
                           bias: Optional[torch.Tensor] = None,
                           out_dtype: torch.dtype = torch.float32,
                           approximate: bool = False) -> torch.Tensor:
    """Plain version of form (c): ``F.gelu`` of form (b)'s output (exact
    erf, or tanh where ``approximate``; bert_tpu's ``jax.nn.gelu``) in
    ``out_dtype``."""
    return F.gelu(int8_matmul_codes_plain(codes, sx, w, bias, out_dtype),
                  approximate="tanh" if approximate else "none")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_x(x: torch.Tensor, what: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be [M, K], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: x dtype {x.dtype} not in (f32, bf16)")
    if x.shape[1] > MAX_K:
        raise ValueError(f"{what}: K={x.shape[1]} > {MAX_K}: K · 127² "
                         "would overflow the int32 sum")


def _check_device(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")


def _quantize_launch(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if not x.is_contiguous():
        raise ValueError("quantize_activations_i8: x must be contiguous")
    m, k = x.shape
    codes = torch.empty((m, round_up(k, KP_ALIGN)), dtype=torch.int8,
                        device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return codes, sx
    fn = ("quantize_rows_i8_f32" if x.dtype == torch.float32
          else "quantize_rows_i8_bf16")
    lib = _kernels.library("int8_matmul")
    with torch.cuda.device(x.device):
        rc = getattr(lib, fn)(x.data_ptr(), codes.data_ptr(), sx.data_ptr(),
                              m, k, _kernels.stream_of(x))
    _kernels.check(rc, fn)
    quantize_activations_i8.launches += 1
    return codes, sx


@counted
def quantize_activations_i8(x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x[M, K] → (codes [M, Kp] int8, zero past K; sx [M] f32), per-row
    symmetric. CPU tensors take :func:`quantize_activations_i8_plain`;
    CUDA tensors launch the kernel or raise."""
    _check_x(x, "quantize_activations_i8")
    if x.device.type == "cpu":
        return quantize_activations_i8_plain(x)
    _check_device(x, "quantize_activations_i8")
    return _quantize_launch(x)


def _check_out(bias: Optional[torch.Tensor], out_dtype: torch.dtype, n: int,
               device: torch.device) -> None:
    """The epilogue's operands: ``out_dtype`` f32 or bf16, and a bias, if
    any, contiguous ``[N]`` in ``out_dtype`` on the product's device."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_matmul: out_dtype {out_dtype} not in (f32, "
                        "bf16)")
    if bias is not None and (tuple(bias.shape) != (n,)
                             or bias.dtype != out_dtype
                             or bias.device != device
                             or not bias.is_contiguous()):
        raise ValueError(f"int8_matmul: bias must be contiguous {out_dtype} "
                         f"({n},) on {device}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")


def _check_weight(codes: torch.Tensor, sx: torch.Tensor,
                  w: Int8Weight) -> None:
    m, kp = codes.shape
    n = w.n
    for name, t, shape, dtype in (
            ("codes", codes, (m, kp), torch.int8),
            ("sx", sx, (m,), torch.float32),
            ("w_nk", w.w_nk, (n, kp), torch.int8),
            ("scale", w.scale, (n,), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != codes.device or not t.is_contiguous()):
            raise ValueError(f"int8_matmul: {name} must be contiguous "
                             f"{dtype} {shape} on {codes.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if kp % KP_ALIGN:
        raise ValueError(f"int8_matmul: Kp={kp} not a multiple of "
                         f"{KP_ALIGN}")
    for name, t in (("codes", codes), ("w_nk", w.w_nk)):
        if t.data_ptr() % 16:  # a TMA tensor map's base
            raise ValueError(f"int8_matmul: {name} at 0x{t.data_ptr():x} "
                             "is not 16-byte aligned")


def _matmul_launch(codes: torch.Tensor, sx: torch.Tensor, w: Int8Weight,
                   bias: Optional[torch.Tensor], out_dtype: torch.dtype,
                   gelu: Optional[bool] = None) -> torch.Tensor:
    """One launch of the matmul kernel into a new [M, N] ``out_dtype``:
    form (a) or (b), or form (c) where ``gelu`` is given (True: the tanh
    form)."""
    m = codes.shape[0]
    out = torch.empty((m, w.n), dtype=out_dtype, device=codes.device)
    if m == 0:
        return out
    fn = "int8_matmul" if gelu is None else "int8_matmul_gelu"
    lib = _kernels.library("int8_matmul")
    with torch.cuda.device(codes.device):
        rc = getattr(lib, fn)(
            codes.data_ptr(), w.w_nk.data_ptr(), sx.data_ptr(),
            w.scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), m, w.kp, w.n, int(out_dtype == torch.bfloat16),
            *(() if gelu is None else (int(gelu),)),
            _kernels.stream_of(codes))
    _kernels.check(rc, fn)
    return out


def _check_codes(codes: torch.Tensor, sx: torch.Tensor, w: Int8Weight,
                 bias: Optional[torch.Tensor], out_dtype: torch.dtype,
                 what: str) -> None:
    """The operands of a product on codes: a device the wrapper serves
    (first, so that another device is named as such), then the codes,
    the weight and the epilogue's."""
    if codes.device.type != "cpu":
        _check_device(codes, what)
    _check_weight(codes, sx, w)
    _check_out(bias, out_dtype, w.n, codes.device)


def int8_matmul_codes(codes: torch.Tensor, sx: torch.Tensor, w: Int8Weight,
                      bias: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """The matmul alone, on padded codes from
    :func:`quantize_activations_i8` or the LayerNorm's codes form: → [M,
    N] in ``out_dtype``, plus ``bias`` (forms (a) and (b)). CPU tensors
    take :func:`int8_matmul_codes_plain`; CUDA tensors launch the kernel
    or raise."""
    _check_codes(codes, sx, w, bias, out_dtype, "int8_matmul")
    if codes.device.type == "cpu":
        return int8_matmul_codes_plain(codes, sx, w, bias, out_dtype)
    out = _matmul_launch(codes, sx, w, bias, out_dtype)
    int8_matmul.launches += 1
    return out


@counted
def int8_matmul_gelu(codes: torch.Tensor, sx: torch.Tensor, w: Int8Weight,
                     bias: Optional[torch.Tensor] = None,
                     out_dtype: torch.dtype = torch.float32,
                     approximate: bool = False) -> torch.Tensor:
    """Form (c) on padded codes: ``F.gelu(form (b))`` [M, N] in
    ``out_dtype`` (tanh GELU where ``approximate``). CPU tensors take
    :func:`int8_matmul_gelu_plain`; CUDA tensors launch the kernel or
    raise."""
    _check_codes(codes, sx, w, bias, out_dtype, "int8_matmul_gelu")
    if codes.device.type == "cpu":
        return int8_matmul_gelu_plain(codes, sx, w, bias, out_dtype,
                                      approximate)
    h = _matmul_launch(codes, sx, w, bias, out_dtype, bool(approximate))
    int8_matmul_gelu.launches += 1
    return h


@counted
def int8_matmul(x: torch.Tensor, w: Int8Weight,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x[M, K] @ (w_i8 · scale)[K, N]``: the activations quantized per
    row, an exact int8 product, the f32 epilogue; then, in ``out_dtype``,
    the product rounded and ``bias`` added (form (b)), or the f32 product
    as it is (form (a): f32 and no bias). CPU tensors take
    :func:`int8_matmul_plain`; CUDA tensors launch both kernels (quantize,
    then matmul) or raise."""
    _check_x(x, "int8_matmul")
    if x.shape[1] != w.k:
        raise ValueError(f"int8_matmul: x has K={x.shape[1]}, the weight "
                         f"K={w.k}")
    _check_out(bias, out_dtype, w.n, x.device)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w, bias, out_dtype)
    _check_device(x, "int8_matmul")
    codes, sx = _quantize_launch(x)
    return int8_matmul_codes(codes, sx, w, bias, out_dtype)

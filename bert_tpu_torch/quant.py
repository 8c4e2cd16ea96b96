"""Q4_0 / Q4_1 block quantization codecs and the group-local weight layout.

Counterpart of ``bert_tpu/quant.py``, kept bit-identical to it (pinned by
tests/test_torch_quant.py). The port keeps the TPU package's group-local
``[K//2, N]`` layout so that weights carry across as an identity on the
arrays, the native repack (csrc/q4repack.cpp) is reused as it stands, and
the CUDA kernel's threads, which map to N, read neighbouring bytes
(bert_tpu_torch/csrc/q4_matmul.cu). A layout tuned for Hopper is later work.

Re-creates the reference's weight-only 4-bit scheme (SURVEY.md §2.5;
models/quantize.cpp:213-218, README.md:15) in two layouts:

1. **ggml stream layout** — bit-compatible with the legacy ggml block codecs
   the reference's quantize binary emits, for ggml-bin file I/O:
     * Q4_0: per 32-value block, f32 scale ``d`` then 16 nibble bytes
       (20 B/block); codes are symmetric around 8: ``x ≈ (q - 8) * d`` with
       ``d = max|x| / 7``.
     * Q4_1: f32 ``d`` + f32 ``m`` then 16 nibble bytes (24 B/block);
       affine: ``x ≈ q * d + m`` with ``d = (max - min)/15``, ``m = min``.
     * nibble packing: byte ``b`` holds elements ``2b`` (low nibble) and
       ``2b + 1`` (high nibble).

2. **TPU layout** (:class:`QuantTensor`) — a structure-of-arrays layout
   pre-tiled for the MXU: for a logical weight ``W[K, N]`` (K = contraction
   dim), codes are packed 2-per-byte along K **group-locally**: within each
   64-row group g, the packed band's LOW nibbles hold rows 64g..64g+31
   (= q4 block 2g) and the HIGH nibbles rows 64g+32..64g+63 (= block 2g+1)
   — see :func:`pack_tpu_layout`. The unpack is a sublane-band concatenate
   per group (no interleave shuffles), and any K-shard cut at 64-row
   granularity is itself a valid packed array (tensor-parallel row sharding
   needs no repacking). Block scales sit in separate ``[K/32, N]`` planes
   that broadcast cleanly over lanes. See bert_tpu_torch/ops/q4_matmul.py
   for the fused dequant+matmul CUDA kernel consuming this layout.

Quantization happens along the weight's input (contraction) dimension in
blocks of 32 — the same axis ggml uses (ne[0]; bert.cpp:638 asserts
``ne[0] % 64 == 0``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

QK = 32  # block size, elements per quantization block

GGML_FTYPE_F32 = 0
GGML_FTYPE_F16 = 1
GGML_FTYPE_Q4_0 = 2
GGML_FTYPE_Q4_1 = 3

FTYPE_NAMES = {0: "f32", 1: "f16", 2: "q4_0", 3: "q4_1"}
FTYPE_BY_NAME = {v: k for k, v in FTYPE_NAMES.items()}


# ---------------------------------------------------------------------------
# Core block codecs (numpy, shape [..., K] with K % 32 == 0)
# ---------------------------------------------------------------------------

def _round_away(x: np.ndarray) -> np.ndarray:
    """Round half AWAY from zero, matching the C ``roundf`` the reference
    quantizer uses (models/quantize.cpp via ggml). np.rint rounds half to
    EVEN, which diverges on exact ties (e.g. 2.5 → rint 2, roundf 3).

    Computed entirely in f32: ``rint`` is exact (no ``|x| + 0.5`` sum, so
    no binade-boundary trap where 0.5 − 2⁻²⁵ + 0.5 ties up to 1.0), and it
    differs from roundf only on EXACT .5 fractions — detectable exactly
    because ``x − trunc(x)`` is exact in f32 wherever a fractional part
    exists (|x| < 2²⁴; above that every f32 is an integer and the
    correction is a no-op). Ties get ``trunc(x) ± 1``. Bit-equality with
    libm roundf is fuzz-pinned in tests/test_quant.py (for the JAX
    package's copy; tests/test_torch_quant.py pins this one to it)."""
    x = np.asarray(x, dtype=np.float32)
    r = np.rint(x)
    t = np.trunc(x)
    frac = x - t
    tie = np.abs(frac, out=frac) == np.float32(0.5)
    return np.where(tie, t + np.sign(x), r)


# Large tensors (the 30k-row word-embedding table) are codec'd in row
# chunks: glibc always services allocations above its 32 MB threshold cap
# with a fresh mmap, so each multi-MB numpy temporary would first-touch
# page-fault its whole extent, which is slow on hosts whose memory is
# restored lazily. Chunking changes nothing numerically (every op
# is per-block within a row); outputs are written into preallocated
# arrays that fault exactly once.
_CHUNK_BYTES = 4 << 20


def _chunked_rows(fn, x, out_specs):
    """Apply fn(rows) → tuple over row chunks of 2-D x, concatenating into
    preallocated outputs shaped by out_specs: (dtype, cols) per output."""
    n = x.shape[0]
    outs = [np.empty((n, cols), dtype) for dtype, cols in out_specs]
    step = max(1, _CHUNK_BYTES // max(1, x.shape[1] * x.itemsize))
    for i in range(0, n, step):
        for dst, part in zip(outs, fn(x[i:i + step])):
            dst[i:i + step] = part
    return tuple(outs)


def q4_0_quantize(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """x[..., K] → (codes uint8 [..., K] in 0..15, scales f32 [..., K//QK])."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    *lead, k = x.shape
    assert k % QK == 0, f"last dim {k} not a multiple of {QK}"
    if x.ndim >= 2 and x.nbytes > _CHUNK_BYTES:
        codes, scales = _chunked_rows(
            q4_0_quantize, x.reshape(-1, k),
            [(np.uint8, k), (np.float32, k // QK)])
        return codes.reshape(*lead, k), scales.reshape(*lead, k // QK)
    blocks = x.reshape(*lead, k // QK, QK)
    amax = np.abs(blocks).max(axis=-1)
    d = amax / 7.0
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    q = _round_away(blocks * inv_d[..., None]) + 8.0
    codes = np.clip(q, 0, 15).astype(np.uint8).reshape(*lead, k)
    return codes, d.astype(np.float32)


def q4_0_dequantize(codes: np.ndarray, scales: np.ndarray) -> np.ndarray:
    *lead, k = codes.shape
    if codes.ndim >= 2 and codes.nbytes * 4 > _CHUNK_BYTES:
        flat_c = np.ascontiguousarray(codes).reshape(-1, k)
        flat_s = np.ascontiguousarray(scales).reshape(-1, k // QK)
        n = flat_c.shape[0]
        out = np.empty((n, k), np.float32)
        step = max(1, _CHUNK_BYTES // (k * 4))
        for i in range(0, n, step):
            out[i:i + step] = q4_0_dequantize(flat_c[i:i + step],
                                              flat_s[i:i + step])
        return out.reshape(*lead, k)
    blocks = codes.reshape(*lead, k // QK, QK).astype(np.float32) - 8.0
    return (blocks * scales[..., None]).reshape(*lead, k).astype(np.float32)


def q4_1_quantize(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """x[..., K] → (codes uint8, scales f32 [..., K//QK], mins f32 [..., K//QK])."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    *lead, k = x.shape
    assert k % QK == 0, f"last dim {k} not a multiple of {QK}"
    if x.ndim >= 2 and x.nbytes > _CHUNK_BYTES:
        codes, scales, mins = _chunked_rows(
            q4_1_quantize, x.reshape(-1, k),
            [(np.uint8, k), (np.float32, k // QK), (np.float32, k // QK)])
        return (codes.reshape(*lead, k), scales.reshape(*lead, k // QK),
                mins.reshape(*lead, k // QK))
    blocks = x.reshape(*lead, k // QK, QK)
    mn = blocks.min(axis=-1)
    mx = blocks.max(axis=-1)
    d = (mx - mn) / 15.0
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    q = _round_away((blocks - mn[..., None]) * inv_d[..., None])
    codes = np.clip(q, 0, 15).astype(np.uint8).reshape(*lead, k)
    return codes, d.astype(np.float32), mn.astype(np.float32)


def q4_1_dequantize(
    codes: np.ndarray, scales: np.ndarray, mins: np.ndarray
) -> np.ndarray:
    *lead, k = codes.shape
    if codes.ndim >= 2 and codes.nbytes * 4 > _CHUNK_BYTES:
        flat_c = np.ascontiguousarray(codes).reshape(-1, k)
        flat_s = np.ascontiguousarray(scales).reshape(-1, k // QK)
        flat_m = np.ascontiguousarray(mins).reshape(-1, k // QK)
        n = flat_c.shape[0]
        out = np.empty((n, k), np.float32)
        step = max(1, _CHUNK_BYTES // (k * 4))
        for i in range(0, n, step):
            out[i:i + step] = q4_1_dequantize(
                flat_c[i:i + step], flat_s[i:i + step], flat_m[i:i + step])
        return out.reshape(*lead, k)
    blocks = codes.reshape(*lead, k // QK, QK).astype(np.float32)
    out = blocks * scales[..., None] + mins[..., None]
    return out.reshape(*lead, k).astype(np.float32)


def q4_roundtrip(x: np.ndarray, ftype: int) -> np.ndarray:
    """Quantize→dequantize a dense f32 tensor: exactly the values a
    Q4-quantized ggml FILE yields after load-time densification
    (formats/ggml_bin.to_f32). Used so quantize-on-load matches the
    write-quantized-file-then-load flow bit for bit on tensors that stay
    dense in memory — the embedding tables, which the reference's
    quantizer DOES quantize (2-D ".*weight" rule, models/quantize.cpp:
    154-167) but which this engine densifies for gathers."""
    if ftype == GGML_FTYPE_Q4_0:
        codes, scales = q4_0_quantize(x)
        return q4_0_dequantize(codes, scales)
    if ftype == GGML_FTYPE_Q4_1:
        codes, scales, mins = q4_1_quantize(x)
        return q4_1_dequantize(codes, scales, mins)
    raise ValueError(f"q4_roundtrip: unsupported ftype {ftype}")


# ---------------------------------------------------------------------------
# ggml stream (file) layout
# ---------------------------------------------------------------------------

def _pack_nibbles_pairwise(codes: np.ndarray) -> np.ndarray:
    """[..., K] codes → [..., K//2] bytes; byte b = el[2b] | el[2b+1] << 4."""
    lo = codes[..., 0::2]
    hi = codes[..., 1::2]
    return (lo | (hi << 4)).astype(np.uint8)


def _unpack_nibbles_pairwise(packed: np.ndarray) -> np.ndarray:
    *lead, half = packed.shape
    out = np.empty((*lead, half * 2), dtype=np.uint8)
    out[..., 0::2] = packed & 0x0F
    out[..., 1::2] = packed >> 4
    return out


def q4_to_ggml_bytes(
    codes: np.ndarray, scales: np.ndarray, mins: Optional[np.ndarray] = None
) -> bytes:
    """Serialize row-major [R, K] codes+scales into the ggml block stream."""
    r, k = codes.shape
    nb = k // QK
    packed = _pack_nibbles_pairwise(codes.reshape(r * nb, QK))  # [R*nb, 16]
    if mins is None:  # Q4_0: f32 d + 16 bytes
        rec = np.zeros((r * nb, 20), dtype=np.uint8)
        rec[:, :4] = scales.reshape(-1, 1).astype(np.float32).view(np.uint8)
        rec[:, 4:] = packed
    else:  # Q4_1: f32 d + f32 m + 16 bytes
        rec = np.zeros((r * nb, 24), dtype=np.uint8)
        rec[:, :4] = scales.reshape(-1, 1).astype(np.float32).view(np.uint8)
        rec[:, 4:8] = mins.reshape(-1, 1).astype(np.float32).view(np.uint8)
        rec[:, 8:] = packed
    return rec.tobytes()


def q4_from_ggml_bytes(
    raw, shape: Tuple[int, ...], ftype: int
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """ggml block stream (bytes or uint8 ndarray/memmap view) →
    ([..., K] codes, scales, mins-or-None)."""
    raw = (np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, bytes)
           else np.asarray(raw, dtype=np.uint8))
    *lead, k = shape
    nblocks = int(np.prod(lead, dtype=np.int64)) * (k // QK)
    if ftype == GGML_FTYPE_Q4_0:
        rec = raw.reshape(nblocks, 20)
        scales = rec[:, :4].copy().view(np.float32).reshape(*lead, k // QK)
        mins = None
        packed = rec[:, 4:]
    elif ftype == GGML_FTYPE_Q4_1:
        rec = raw.reshape(nblocks, 24)
        scales = rec[:, :4].copy().view(np.float32).reshape(*lead, k // QK)
        mins = rec[:, 4:8].copy().view(np.float32).reshape(*lead, k // QK)
        packed = rec[:, 8:]
    else:
        raise ValueError(f"not a q4 ftype: {ftype}")
    codes = _unpack_nibbles_pairwise(packed).reshape(*lead, k)
    return codes, scales, mins


def nibble_histogram(codes: np.ndarray) -> np.ndarray:
    """16-bin code histogram, as printed by the reference quantizer
    (models/quantize.cpp:123,229-261)."""
    return np.bincount(codes.reshape(-1).astype(np.int64), minlength=16)[:16]


def ggml_nbytes(shape: Tuple[int, ...], ftype: int) -> int:
    n = int(np.prod(shape, dtype=np.int64))
    if ftype == GGML_FTYPE_F32:
        return n * 4
    if ftype == GGML_FTYPE_F16:
        return n * 2
    if ftype == GGML_FTYPE_Q4_0:
        return n // QK * 20
    if ftype == GGML_FTYPE_Q4_1:
        return n // QK * 24
    raise ValueError(f"unknown ftype {ftype}")


# ---------------------------------------------------------------------------
# TPU layout
# ---------------------------------------------------------------------------

@dataclass
class QuantTensor:
    """MXU-tiled weight-only Q4 tensor for a logical ``W[K, N]`` matmul weight.

    ``packed[K//2, N]`` uint8, GROUP-LOCAL half-split: packed row r holds in
    its low nibble logical row ``64*(r//32) + (r%32)`` and in its high
    nibble that row + 32 (i.e. each 32-packed-row band covers one 64-row
    group; see pack_tpu_layout). ``scales[K//32, N]`` f32 (Q4_0/Q4_1),
    ``mins[K//32, N]`` f32 (Q4_1 only).

    The fields hold numpy arrays on the host and torch tensors once the
    weights are on their device (params.params_to_torch); the layout is the
    same either way.
    """

    packed: np.ndarray
    scales: np.ndarray
    mins: Optional[np.ndarray] = None

    @property
    def k(self) -> int:
        return self.packed.shape[-2] * 2

    @property
    def n(self) -> int:
        return self.packed.shape[-1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.k, self.n)

    @property
    def is_q4_1(self) -> bool:
        return self.mins is not None


GROUP = 2 * QK  # 64 logical rows per packed group (one packed 32-row band)


def pack_tpu_layout(codes_kn: np.ndarray) -> np.ndarray:
    """[K, N] codes → [K//2, N] group-local half-split packed bytes.

    Within each 64-row group g, the packed band's LOW nibbles hold logical
    rows 64g..64g+31 (= q4 block 2g) and the HIGH nibbles rows
    64g+32..64g+63 (= block 2g+1). Group-locality means any K-shard cut at
    64-row granularity is itself a valid packed array — so tensor-parallel
    row sharding of ``packed`` (and the matching ``scales``) over a mesh
    needs no repacking. The 64-row granularity is the same one the
    reference's loader asserts (bert.cpp:638: ``ne[0] % 64 == 0``).
    """
    k, n = codes_kn.shape
    assert k % GROUP == 0, f"K={k} not a multiple of {GROUP}"
    g = codes_kn.reshape(k // GROUP, GROUP, n)
    lo, hi = g[:, :QK], g[:, QK:]
    return (lo | (hi << 4)).astype(np.uint8).reshape(k // 2, n)


def unpack_tpu_layout(packed: np.ndarray) -> np.ndarray:
    """[K//2, N] packed bytes → [K, N] codes (inverse of pack_tpu_layout)."""
    half, n = packed.shape
    p = packed.reshape(half // QK, QK, n)
    codes = np.concatenate([p & 0x0F, p >> 4], axis=1)  # [K//64, 64, N]
    return codes.reshape(half * 2, n).astype(np.uint8)


def quantize_tensor_tpu(
    w_kn: np.ndarray, ftype: int
) -> QuantTensor:
    """Quantize a dense ``W[K, N]`` (K = contraction dim) into TPU layout.

    Blocks run along K, matching ggml's ne[0] blocking, so repacking a
    ggml-quantized tensor (codes produced by q4_from_ggml_bytes on the
    [N, K]-stored file tensor) into this layout is a pure transpose —
    bit-exact, no requantization. See formats/ggml_bin.py.
    """
    k, n = w_kn.shape
    if ftype == GGML_FTYPE_Q4_0:
        codes, scales = q4_0_quantize(w_kn.T)  # [N, K] codes, [N, K//QK]
        mins = None
    elif ftype == GGML_FTYPE_Q4_1:
        codes, scales, mins = q4_1_quantize(w_kn.T)
        mins = np.ascontiguousarray(mins.T)  # [K//QK, N]
    else:
        raise ValueError(f"not a q4 ftype: {ftype}")
    packed = pack_tpu_layout(np.ascontiguousarray(codes.T))  # [K//2, N]
    return QuantTensor(
        packed=packed,
        scales=np.ascontiguousarray(scales.T),
        mins=mins,
    )


def repack_codes_tpu(
    codes_nk: np.ndarray,
    scales_nb: np.ndarray,
    mins_nb: Optional[np.ndarray],
) -> QuantTensor:
    """Bit-exact repack of ggml-layout codes ([N, K], blocks along K) into the
    TPU layout for the logical weight W[K, N] = stored[N, K]ᵀ."""
    packed = pack_tpu_layout(np.ascontiguousarray(codes_nk.T))
    return QuantTensor(
        packed=packed,
        scales=np.ascontiguousarray(scales_nb.T),
        mins=None if mins_nb is None else np.ascontiguousarray(mins_nb.T),
    )


def repack_ggml_stream_tpu(qraw, shape: Tuple[int, int],
                           ftype: int) -> QuantTensor:
    """ggml block stream of a stored [N, K] q4 tensor → TPU-layout
    QuantTensor for the logical W[K, N], in ONE fused pass.

    Bit-exact equal to ``repack_codes_tpu(*q4_from_ggml_bytes(...))`` but
    never materializes the full-size [N, K] codes array (the unpack →
    transpose → group-pack chain touches ~3.5× the packed bytes in fresh
    allocations); every temporary stays at packed (half) size.

    Derivation: ggml block b of stored row n covers K columns
    32b..32b+31 with pairwise nibbles (byte j = c[32b+2j] | c[32b+2j+1]<<4,
    see _pack_nibbles_pairwise); the TPU layout's group g band packs
    logical K-rows 64g+r (low nibble) and 64g+32+r (high) — i.e. block 2g
    element r and block 2g+1 element r (pack_tpu_layout)."""
    qraw = (np.frombuffer(qraw, dtype=np.uint8) if isinstance(qraw, bytes)
            else np.asarray(qraw, dtype=np.uint8))
    n, k = shape
    if k % GROUP != 0:
        raise ValueError(f"K={k} not a multiple of {GROUP}")
    if ftype not in (GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1):
        raise ValueError(f"not a q4 ftype: {ftype}")
    nblocks = n * (k // QK)
    meta = 4 if ftype == GGML_FTYPE_Q4_0 else 8

    # native single-pass repack (csrc/q4repack.cpp) when the toolchain
    # built it — one read + one write per byte instead of numpy's ~4
    # strided passes; bit-exactness pinned by tests/test_torch_quant.py
    from .native import native_q4_repack

    nat = native_q4_repack(qraw, n, k, meta)
    if nat is not None:
        packed, scales, mins = nat
        return QuantTensor(packed=packed, scales=scales, mins=mins)

    rec = qraw.reshape(nblocks, meta + 16)
    scales = np.ascontiguousarray(
        rec[:, :4].copy().view(np.float32).reshape(n, k // QK).T)
    mins = None
    if ftype == GGML_FTYPE_Q4_1:
        mins = np.ascontiguousarray(
            rec[:, 4:8].copy().view(np.float32).reshape(n, k // QK).T)
    elif ftype != GGML_FTYPE_Q4_0:
        raise ValueError(f"not a q4 ftype: {ftype}")
    # [n, K//64 group, 2 blocks, 16 packed bytes]
    pg = rec[:, meta:].reshape(n, k // GROUP, 2, 16)
    lo_half, hi_half = pg[:, :, 0, :], pg[:, :, 1, :]  # blocks 2g, 2g+1
    band = np.empty((n, k // GROUP, QK), dtype=np.uint8)
    # low nibble of the TPU byte = block-2g element r
    band[..., 0::2] = lo_half & 0x0F
    band[..., 1::2] = lo_half >> 4
    hi = np.empty_like(band)  # high nibble = block-2g+1 element r
    hi[..., 0::2] = hi_half & 0x0F
    hi[..., 1::2] = hi_half >> 4
    band |= hi << 4
    packed = np.ascontiguousarray(band.reshape(n, k // 2).T)
    return QuantTensor(packed=packed, scales=scales, mins=mins)


def concat_quant_n(qts, col_order: Optional[np.ndarray] = None
                   ) -> QuantTensor:
    """Concatenate QuantTensors along the logical N (output) axis, with an
    optional column permutation — the fused-QKV composition. N is the last
    axis of every component (packed/scales/mins), so this is exact for
    packed bytes (packing runs along K only)."""
    def cat(parts):
        out = np.concatenate(parts, axis=-1)
        return out if col_order is None else np.take(out, col_order, axis=-1)

    return QuantTensor(
        packed=cat([q.packed for q in qts]),
        scales=cat([q.scales for q in qts]),
        mins=(cat([q.mins for q in qts])
              if qts[0].mins is not None else None),
    )


def dequantize_tpu(qt: QuantTensor) -> np.ndarray:
    """QuantTensor → dense f32 W[K, N] (numpy reference for kernel tests)."""
    codes = unpack_tpu_layout(np.asarray(qt.packed))  # [K, N]
    k, n = codes.shape
    scales = np.repeat(np.asarray(qt.scales), QK, axis=0)  # [K, N]
    if qt.mins is None:
        return (codes.astype(np.float32) - 8.0) * scales
    mins = np.repeat(np.asarray(qt.mins), QK, axis=0)
    return codes.astype(np.float32) * scales + mins


def stack_quant(qts) -> QuantTensor:
    """Stack per-layer QuantTensors into ONE layer-leading QuantTensor
    (the layer-stacked leaf layout). The single home for this layout rule,
    shared by loader.py and params.py."""
    return QuantTensor(
        packed=np.stack([q.packed for q in qts]),
        scales=np.stack([q.scales for q in qts]),
        mins=(np.stack([q.mins for q in qts])
              if qts[0].mins is not None else None),
    )

"""ggml-bin model file reader/writer.

Counterpart of ``bert_tpu/formats/ggml_bin.py``: the writer's output is
byte-identical to it (tests/test_torch_quant.py). Implements the exact on-disk format shared by the reference's converter
(models/convert-to-ggml.py:68-108), quantizer (models/quantize.cpp:56-245)
and loader (bert.cpp:331-694) — SURVEY.md §2.4. All little-endian:

  1. magic ``0x67676d6c`` ("ggml")
  2. 7 × int32 hparams: n_vocab, n_max_tokens, n_embd, n_intermediate,
     n_head, n_layer, ftype (0=f32 1=f16 2=q4_0 3=q4_1)
  3. vocab: n_vocab × (uint32 len + UTF-8 bytes), id order
  4. tensor records until EOF:
     int32 n_dims, int32 name_len, int32 ftype,
     n_dims × int32 dims in ggml ``ne`` order (= numpy shape REVERSED),
     name bytes, raw data (f32 / f16 / q4 block stream).

Q4 tensors must satisfy ``ne[0] % 64 == 0`` (bert.cpp:638,642). Tensors are
2-D at most. The writer quantizes 2-D ``*.weight`` tensors only, leaving
biases/LayerNorms f32, matching models/quantize.cpp:154-167.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..quant import (
    GGML_FTYPE_F16,
    GGML_FTYPE_F32,
    GGML_FTYPE_Q4_0,
    GGML_FTYPE_Q4_1,
    ggml_nbytes,
    q4_0_quantize,
    q4_1_quantize,
    q4_to_ggml_bytes,
)

GGML_MAGIC = 0x67676D6C



@dataclass
class GgmlHParams:
    n_vocab: int
    n_max_tokens: int
    n_embd: int
    n_intermediate: int
    n_head: int
    n_layer: int
    ftype: int  # the file-level "f16" field

    def pack(self) -> bytes:
        return struct.pack(
            "<7i",
            self.n_vocab,
            self.n_max_tokens,
            self.n_embd,
            self.n_intermediate,
            self.n_head,
            self.n_layer,
            self.ftype,
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "GgmlHParams":
        return cls(*struct.unpack("<7i", raw))


class TensorRecord:
    """One tensor as stored: numpy-ordered shape, per-tensor ftype, and either
    dense data (f32/f16) or the raw q4 block stream (``qraw``, possibly a
    zero-copy mmap view). ``codes``/``scales``/``mins`` unpack LAZILY on
    first access — the hot load path (loader.params_from_ggml) never
    touches them, going straight from the stream to the group-local layout
    via :func:`~bert_tpu_torch.quant.repack_ggml_stream_tpu`."""

    def __init__(self, name: str, shape: Tuple[int, ...], ftype: int,
                 data: Optional[np.ndarray] = None,
                 qraw: Optional[np.ndarray] = None):
        self.name = name
        self.shape = shape  # numpy order (ggml ne reversed)
        self.ftype = ftype
        self.data = data  # dense f32/f16 (view or array)
        self.qraw = qraw  # q4 block stream bytes (view or array)
        self._codes = self._scales = self._mins = None

    def _unpack(self):
        if self._codes is None and self.qraw is not None:
            from ..quant import q4_from_ggml_bytes

            self._codes, self._scales, self._mins = q4_from_ggml_bytes(
                self.qraw, self.shape, self.ftype)

    @property
    def codes(self) -> Optional[np.ndarray]:  # uint8 [..., K], values 0..15
        self._unpack()
        return self._codes

    @property
    def scales(self) -> Optional[np.ndarray]:  # f32 [..., K//32]
        self._unpack()
        return self._scales

    @property
    def mins(self) -> Optional[np.ndarray]:  # f32 [..., K//32] (q4_1)
        self._unpack()
        return self._mins

    def to_quant_tpu(self):
        """Fused stream → TPU-layout QuantTensor (2-D q4 tensors only)."""
        from ..quant import repack_ggml_stream_tpu

        return repack_ggml_stream_tpu(self.qraw, self.shape, self.ftype)

    def to_f32(self) -> np.ndarray:
        from ..quant import q4_0_dequantize, q4_1_dequantize

        if self.ftype in (GGML_FTYPE_F32, GGML_FTYPE_F16):
            return self.data.astype(np.float32)
        if self.ftype == GGML_FTYPE_Q4_0:
            return q4_0_dequantize(self.codes, self.scales)
        if self.ftype == GGML_FTYPE_Q4_1:
            return q4_1_dequantize(self.codes, self.scales, self.mins)
        raise ValueError(f"unknown ftype {self.ftype}")


@dataclass
class GgmlModelFile:
    hparams: GgmlHParams
    vocab_tokens: List[str]
    tensors: Dict[str, TensorRecord] = field(default_factory=dict)


def read_ggml(path: str, mmap: bool = True) -> GgmlModelFile:
    """Parse a ggml-bin file. With ``mmap`` (the default) tensor payloads
    are ZERO-COPY views into a read-only file mapping — the reference
    freads every byte into its arena (bert.cpp:558-674, its own noted hot
    spot); here pages fault in lazily exactly once, during the single
    fused repack/densify pass. ``mmap=False`` reads the file as a stream
    and copies each payload, for file systems without mmap; the records
    are the same."""
    if not mmap:
        return _read_ggml_stream(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    buf = memoryview(mm)

    def take(n: int, what: str) -> int:
        nonlocal off
        if off + n > len(mm):
            raise ValueError(f"{path}: truncated {what}")
        off += n
        return off - n

    off = 0
    (magic,) = struct.unpack_from("<I", buf, take(4, "magic"))
    if magic != GGML_MAGIC:
        raise ValueError(f"{path}: bad magic {magic:#x} (want {GGML_MAGIC:#x})")
    hparams = GgmlHParams.unpack(bytes(buf[take(28, "hparams"):off]))

    vocab_tokens: List[str] = []
    # one bulk decode would be nicer, but token lengths are interleaved;
    # unpack_from keeps this a pure in-memory scan (no per-token syscalls)
    for i in range(hparams.n_vocab):
        (ln,) = struct.unpack_from("<I", buf, take(4, f"vocab entry {i}"))
        start = take(ln, f"vocab token {i}")
        vocab_tokens.append(bytes(buf[start:off]).decode(
            "utf-8", errors="replace"))

    tensors: Dict[str, TensorRecord] = {}
    while off < len(mm):
        if off + 12 > len(mm):
            break  # trailing partial header = EOF (bert.cpp:574)
        n_dims, name_len, ftype = struct.unpack_from(
            "<3i", buf, take(12, "tensor header"))
        ne = struct.unpack_from(f"<{n_dims}i", buf,
                                take(4 * n_dims, "tensor dims"))
        start = take(name_len, "tensor name")
        name = bytes(buf[start:off]).decode("utf-8")
        nbytes = ggml_nbytes(tuple(reversed(ne)), ftype)
        start = take(nbytes, f"tensor {name!r}")
        tensors[name] = _record(path, name, ne, ftype,
                                mm[start:off])  # zero-copy view
    return GgmlModelFile(hparams=hparams, vocab_tokens=vocab_tokens,
                         tensors=tensors)


def _record(path: str, name: str, ne: Tuple[int, ...], ftype: int,
            raw: np.ndarray) -> TensorRecord:
    """One tensor over its payload bytes ``raw`` (uint8): the dense data
    or the q4 block stream, as views of ``raw``."""
    shape = tuple(reversed(ne))  # back to numpy order
    rec = TensorRecord(name=name, shape=shape, ftype=ftype)
    if ftype == GGML_FTYPE_F32:
        rec.data = raw.view("<f4").reshape(shape)
    elif ftype == GGML_FTYPE_F16:
        rec.data = raw.view("<f2").reshape(shape)
    elif ftype in (GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1):
        if ne[0] % 64 != 0:  # bert.cpp:638,642
            raise ValueError(
                f"{path}: q4 tensor {name!r} ne[0]={ne[0]} "
                "not multiple of 64")
        rec.qraw = raw
    else:
        raise ValueError(f"{path}: unknown ftype {ftype} for {name!r}")
    return rec


def _read_ggml_stream(path: str) -> GgmlModelFile:
    """Streaming fallback of :func:`read_ggml` (copies payloads), with
    bert_tpu's error messages and EOF rule."""
    with open(path, "rb") as f:

        def read(n: int, what: str) -> bytes:
            raw = f.read(n)
            if len(raw) != n:
                raise ValueError(f"{path}: truncated {what}")
            return raw

        (magic,) = struct.unpack("<I", read(4, "magic"))
        if magic != GGML_MAGIC:
            raise ValueError(f"{path}: bad magic {magic:#x} (want {GGML_MAGIC:#x})")
        hparams = GgmlHParams.unpack(read(28, "hparams"))

        vocab_tokens: List[str] = []
        for i in range(hparams.n_vocab):
            (ln,) = struct.unpack("<I", read(4, f"vocab at entry {i}"))
            tok = read(ln, f"vocab token {i}")
            vocab_tokens.append(tok.decode("utf-8", errors="replace"))

        tensors: Dict[str, TensorRecord] = {}
        while True:
            header = f.read(12)
            if len(header) < 12:
                break  # trailing partial header = EOF (bert.cpp:574)
            n_dims, name_len, ftype = struct.unpack("<3i", header)
            ne = struct.unpack(f"<{n_dims}i",
                               read(4 * n_dims, "tensor dims"))
            name = read(name_len, "tensor name").decode("utf-8")
            raw = read(ggml_nbytes(tuple(reversed(ne)), ftype),
                       f"tensor {name!r}")
            # the payload's own (writable) copy
            tensors[name] = _record(path, name, ne, ftype, np.frombuffer(
                bytearray(raw), dtype=np.uint8))
    return GgmlModelFile(hparams=hparams, vocab_tokens=vocab_tokens,
                         tensors=tensors)


def _tensor_ftype_for(name: str, arr: np.ndarray, file_ftype: int) -> int:
    """Per-tensor storage dtype rule shared by converter and quantizer:
    only 2-D ``*.weight`` tensors take the file dtype; everything else is f32
    (convert-to-ggml.py:93-98, quantize.cpp:154-167)."""
    if file_ftype == GGML_FTYPE_F32:
        return GGML_FTYPE_F32
    # 2-D ".weight" tensors quantize (the reference's ".*weight" regex,
    # models/quantize.cpp:36,154 — endswith implements the same rule)
    if arr.ndim == 2 and name.endswith(".weight"):
        return file_ftype
    return GGML_FTYPE_F32


def write_ggml(
    path: str,
    hparams: GgmlHParams,
    vocab_tokens: List[str],
    tensors: Dict[str, np.ndarray],
    tensor_order: Optional[List[str]] = None,
) -> None:
    """Write a ggml-bin file from dense f32 tensors (numpy-ordered shapes),
    quantizing / f16-casting eligible tensors per ``hparams.ftype``."""
    order = tensor_order if tensor_order is not None else list(tensors.keys())
    with open(path, "wb") as f:
        f.write(struct.pack("<I", GGML_MAGIC))
        f.write(hparams.pack())
        for tok in vocab_tokens:
            raw = tok.encode("utf-8")
            f.write(struct.pack("<I", len(raw)))
            f.write(raw)
        for name in order:
            arr = np.ascontiguousarray(tensors[name])
            tft = _tensor_ftype_for(name, arr, hparams.ftype)
            ne = tuple(reversed(arr.shape))  # ggml order (convert-to-ggml.py:104)
            name_b = name.encode("utf-8")
            f.write(struct.pack("<3i", arr.ndim, len(name_b), tft))
            f.write(struct.pack(f"<{arr.ndim}i", *ne))
            f.write(name_b)
            if tft == GGML_FTYPE_F32:
                f.write(arr.astype("<f4").tobytes())
            elif tft == GGML_FTYPE_F16:
                f.write(arr.astype("<f2").tobytes())
            elif tft == GGML_FTYPE_Q4_0:
                if ne[0] % 64 != 0:
                    raise ValueError(f"q4 tensor {name!r} ne[0]={ne[0]} % 64 != 0")
                codes, scales = q4_0_quantize(arr.astype(np.float32))
                f.write(q4_to_ggml_bytes(codes.reshape(-1, arr.shape[-1]),
                                         scales, None))
            elif tft == GGML_FTYPE_Q4_1:
                if ne[0] % 64 != 0:
                    raise ValueError(f"q4 tensor {name!r} ne[0]={ne[0]} % 64 != 0")
                codes, scales, mins = q4_1_quantize(arr.astype(np.float32))
                f.write(q4_to_ggml_bytes(codes.reshape(-1, arr.shape[-1]),
                                         scales, mins))
            else:
                raise ValueError(f"unknown ftype {tft}")

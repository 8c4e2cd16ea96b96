"""ctypes bindings for the repo's shared native library (csrc/).

Counterpart of ``bert_tpu/native.py``: the same ``csrc/libwordpiece.so``
(WordPiece tokenizer + fused q4 stream repack), built by ``make -C csrc``
the first time it is needed. Python semantics are the fallback everywhere,
so the package works without a host compiler; the tests pin both paths to
the JAX package's.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import subprocess
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_LIB_PATH = os.path.join(_CSRC, "libwordpiece.so")

_lib = None


def build_native(force: bool = False) -> Optional[str]:
    """Build libwordpiece.so with make (``force``: even when it exists);
    returns its path, or None when the host has no toolchain (callers
    then take the Python paths)."""
    if os.path.exists(_LIB_PATH) and not force:
        return _LIB_PATH
    try:
        subprocess.run(["make", "-C", _CSRC, "-s", "libwordpiece.so"],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as exc:
        logger.debug("native build failed: %s", exc)
        return None
    return _LIB_PATH if os.path.exists(_LIB_PATH) else None


def _load_lib(auto_build: bool = True):
    global _lib
    if _lib is not None:
        return _lib
    path = _LIB_PATH if os.path.exists(_LIB_PATH) else (
        build_native() if auto_build else None)
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.wp_vocab_create.restype = ctypes.c_void_p
    lib.wp_vocab_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.wp_vocab_free.argtypes = [ctypes.c_void_p]
    lib.wp_tokenize.restype = ctypes.c_int32
    lib.wp_tokenize.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.wp_tokenize_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.q4_repack_stream_tpu.restype = ctypes.c_int32
    lib.q4_repack_stream_tpu.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def native_q4_repack(qraw: np.ndarray, n: int, k: int, meta: int):
    """Fused ggml q4 block stream → (packed[K/2,N], scales[K/32,N],
    mins-or-None) via csrc/q4repack.cpp; returns None when the native lib
    is unavailable (caller falls back to numpy). ``qraw`` must be a
    C-contiguous uint8 array (mmap views from read_ggml qualify)."""
    lib = _load_lib()
    if lib is None:
        return None
    qraw = np.ascontiguousarray(qraw, dtype=np.uint8)
    # the C side has no buffer-length parameter, so the size contract is
    # enforced here: n rows × k/32 blocks × (meta scale bytes + 16 nibble
    # bytes) — an undersized stream would be read out of bounds
    if k % 32 or qraw.size != n * (k // 32) * (meta + 16):
        return None
    packed = np.empty((k // 2, n), dtype=np.uint8)
    scales = np.empty((k // 32, n), dtype=np.float32)
    mins = np.empty((k // 32, n), dtype=np.float32) if meta == 8 else None
    rc = lib.q4_repack_stream_tpu(
        qraw.ctypes.data_as(ctypes.c_void_p), n, k, meta,
        packed.ctypes.data_as(ctypes.c_void_p),
        scales.ctypes.data_as(ctypes.c_void_p),
        mins.ctypes.data_as(ctypes.c_void_p) if mins is not None else None)
    if rc != 0:
        return None
    return packed, scales, mins


class NativeWordPiece:
    """Native tokenizer over a vocab; same output as WordPieceTokenizer."""

    def __init__(self, tokens: Sequence[str], cls_id: int, sep_id: int):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("libwordpiece.so unavailable")
        self._lib = lib
        payload = bytearray()
        for tok in tokens:
            raw = tok.encode("utf-8")
            payload += struct.pack("<I", len(raw)) + raw
        buf = bytes(payload)
        self._handle = lib.wp_vocab_create(buf, len(buf), len(tokens),
                                           cls_id, sep_id)
        if not self._handle:
            raise RuntimeError("wp_vocab_create failed")

    @staticmethod
    def available(auto_build: bool = True) -> bool:
        return _load_lib(auto_build=auto_build) is not None

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.wp_vocab_free(handle)
            self._handle = None

    def tokenize(self, text: str, n_max_tokens: int = 1 << 30) -> List[int]:
        # errors="ignore": a lone surrogate must be DROPPED, exactly as the
        # pure-Python path drops it, not raise UnicodeEncodeError
        raw = text.encode("utf-8", errors="ignore")
        cap = min(n_max_tokens, len(raw) + 2)
        out = (ctypes.c_int32 * cap)()
        n = self._lib.wp_tokenize(self._handle, raw, len(raw), out, cap)
        return list(out[:n])

    # Below this batch size a thread pool costs more than it saves.
    _MIN_PER_THREAD = 512

    def _thread_count(self, n: int, n_threads: Optional[int]) -> int:
        """Worker threads for a batch of ``n``: ``n_threads`` when given,
        else a nonzero int in ``BERT_TPU_TOKENIZE_THREADS`` as it stands,
        else one per core but never fewer than _MIN_PER_THREAD sentences
        each; clamped to [1, n]."""
        if n_threads is None:
            try:
                env = int(os.environ.get("BERT_TPU_TOKENIZE_THREADS", "0"))
            except ValueError:
                # a malformed value (e.g. 'auto') takes the default: it
                # must not fail every tokenize call
                logger.warning("BERT_TPU_TOKENIZE_THREADS is not an int; "
                               "using the auto default")
                env = 0
            # the amortization threshold gates only the auto default
            n_threads = env or min(os.cpu_count() or 1,
                                   n // self._MIN_PER_THREAD)
        return max(1, min(n_threads, n))

    def tokenize_batch(self, texts: Sequence[str], n_max_tokens: int,
                       n_threads: Optional[int] = None) -> List[List[int]]:
        """One FFI call per worker for the whole batch. ctypes releases the
        GIL for the duration of wp_tokenize_batch and the native core is
        stateless over a read-only vocab, so contiguous slices tokenize on
        a thread pool in true parallel (:meth:`_thread_count` threads)."""
        n = len(texts)
        n_threads = self._thread_count(n, n_threads)
        out = np.empty((n, n_max_tokens), dtype=np.int32)
        lens = np.empty((n,), dtype=np.int32)

        def work(start: int, end: int) -> None:
            payload = bytearray()
            for t in texts[start:end]:
                raw = t.encode("utf-8", errors="ignore")  # see tokenize()
                payload += struct.pack("<I", len(raw)) + raw
            buf = bytes(payload)
            self._lib.wp_tokenize_batch(
                self._handle, buf, len(buf), end - start,
                out[start:].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                lens[start:].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                n_max_tokens,
            )

        if n_threads <= 1:
            work(0, n)
        else:
            from concurrent.futures import ThreadPoolExecutor

            step = -(-n // n_threads)  # ceil
            bounds = [(s, min(n, s + step)) for s in range(0, n, step)]
            with ThreadPoolExecutor(max_workers=len(bounds)) as ex:
                list(ex.map(lambda b: work(*b), bounds))
        return [out[i, : lens[i]].tolist() for i in range(n)]

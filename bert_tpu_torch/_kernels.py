"""Build and bind the package's CUDA kernels (bert_tpu_torch/csrc/*.cu).

Pallas compiled its kernels in-process; this module is what stands in for
that on the H100. Each source is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface under
``build/bert_tpu_torch/`` (beside the package, git-ignored), the first time
it is needed, and loaded with ctypes. Libraries are keyed by a hash of
their source, the shared headers and the flags, so an edited kernel
rebuilds and an unchanged one is reused. :func:`build` starts one ``nvcc``
per source, all at once.

Every pointer and the stream are passed as ``ctypes.c_void_p`` (a bare
Python int would be cut to 32 bits). Each C entry point launches on the
given stream and returns ``cudaGetLastError()``; :func:`check` raises if it
is not 0. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "bert_tpu_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# source name → {C entry point: argtypes}; every entry returns an int
SIGNATURES: Dict[str, Dict[str, list]] = {
    "q4_matmul": {
        # x, packed, scales, mins (nullable), out, M, K, N, stream
        **{f"q4_matmul_{t}": [_P, _P, _P, _P, _P, _I, _I, _I, _P]
           for t in ("f32", "bf16", "bf16_wgmma")},
        # the wgmma instance's bf16 form: x, packed, scales, mins, bias
        # (nullable), out, M, K, N, stream
        "q4_matmul_bf16_wgmma_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _P],
    },
    "layer_norm": {
        # x, residual (nullable), pre_bias (nullable), scale, bias, out,
        # M, D, eps, stream; f32_bf16: x f32, residual and out bf16
        **{f"layer_norm_{t}": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P]
           for t in ("f32", "bf16", "f32_bf16")},
        # the codes form: ... out, codes, sx, M, D, eps, stream
        **{f"layer_norm_codes_{t}": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _F, _P]
           for t in ("f32", "bf16", "f32_bf16")},
        # the add form: x, residual, scale, bias, out, sum_out, M, D, eps,
        # stream
        **{f"layer_norm_add_{t}": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P]
           for t in ("f32", "bf16", "f32_bf16")},
        # the RMS form: x, row stride, scale, out, M, D, eps, stream
        "rms_norm_bf16": [_P, _I, _P, _P, _I, _I, _F, _P],
        # its add form: y (f32), x, scale, out, sum_out, M, D, eps, stream
        "rms_norm_add_f32_bf16": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
    },
    "fused_attention": {
        # qkv, bias, out, B, T, H, d_head, pairwise, scale, stream
        **{f"fused_attention_{t}": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
           for t in ("f32", "bf16")},
        # the long-T form: qkv, bias (key-side), out, B, T, H, d_head,
        # scale, stream
        "fused_attention_wgmma_bf16": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
        # qkv, bias, out, B, T, H, d_head, pairwise, window, scale, tiles
        # (nullable), stream
        **{f"fused_attention_band_{t}": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                         _F, _P, _P]
           for t in ("f32", "bf16")},
        # qkv (rotated in place), cos, sin, pos (nullable), B, T, H, d_head,
        # stream
        **{f"rope_qkv_{t}": [_P, _P, _P, _P, _I, _I, _I, _I, _P]
           for t in ("f32", "bf16")},
    },
    "mla_attention": {
        # q, kva (rotated in place), cos, sin, B, T, H, ldq, ldkv, rank,
        # stream
        "rope_mla_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # q, kva, kvb, out, B, T, H, ldq, ldkv, ldkvb, rank, scale, stream
        "causal_mla_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _I, _F, _P],
    },
    "moe": {
        # logits, M, E, K, scaling, topi, topw, stream
        "moe_topk": [_P, _I, _I, _I, _F, _P, _P, _P],
        # topi, R, K, E, sorted_tok, slot_pos, counts, tile_e, tile_r0,
        # tile_r1, n_tiles, acc (nullable), stream
        "moe_sort": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
        # x, ldx, gather (nullable), packed, scales, tile_e, tile_r0,
        # tile_r1, n_tiles, max_tiles, out, ldo, K, N, swiglu, stream
        "expert_q4_matmul_bf16": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                                  _I, _I, _I, _I, _P],
        # shared, y, w, pos, out, M, K, D, stream
        "moe_combine": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
    "attention": {
        # q, k, v, bias, out, B, H, T, d_head, pairwise, scale, stream
        f"mha_{t}": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
        for t in ("f32", "bf16")
    },
    "int8_matmul": {
        # x, codes, sx, M, K, stream
        **{f"quantize_rows_i8_{t}": [_P, _P, _P, _I, _I, _P]
           for t in ("f32", "bf16")},
        # codes, w_nk, sx, scale, bias (nullable), out, M, Kp, N,
        # bf16_out, stream
        "int8_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # form (c): ... out, M, Kp, N, bf16_out, tanh_approx, stream
        "int8_matmul_gelu": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name → {"seconds": build time, "log": nvcc/ptxas output}, for this process
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH): the CUDA "
                           "kernels of bert_tpu_torch build only on a host "
                           "with the CUDA toolkit")
    return found


def lib_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source, the shared headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(SRC_DIR, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns name → library path; raises
    RuntimeError naming each source that failed, with nvcc's output."""
    names = list(SIGNATURES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = f"{paths[n]}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(SRC_DIR, n + ".cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        log = out.decode(errors="replace")
        build_info[n] = {"seconds": round(time.perf_counter() - t0, 3),
                         "log": log}
        if proc.returncode != 0 or not os.path.exists(tmp):
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log[-4000:]}")
            continue
        os.replace(tmp, paths[n])  # atomic: a reader never sees half a lib
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream

#!/usr/bin/env python3
"""On-card smoke test of bert_tpu_torch, the PyTorch/CUDA port for an H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one CUDA card and the CUDA
toolkit (nvcc). It imports only the port (never JAX or bert_tpu), and:

1. prints the card's name and power limit, then builds every kernel of the
   port from bert_tpu_torch/csrc/ (one nvcc per source, in parallel);
2. kernel phase: holds each kernel against its plain PyTorch version on the
   card, at the paths' shapes, at bert-base and bge-large shapes and at
   edge shapes (one row, N not a multiple of 16, ragged T with fully
   masked rows), in f32 and bf16, and times kernel, plain version and
   (where one PyTorch call computes the same function) that call at every
   shape of the main path: device time from CUDA-graph replay between CUDA
   events, and the kernel's eager time beside it; times the q4 kernel
   against the router's dequantize-then-matmul branch at large M; holds
   the LayerNorm at the paths' shapes, at M = 1, at D = 129, 130, 1,280
   and 4,096 and in its f32-input form (timed beside F.layer_norm and
   beside cast + kernel); holds the per-(batch, head) attention at ragged
   T (1-2,047), at head dims 1-256 and at the warmup grid's largest shape
   (64x2048) and at 4x8x512 with d_head 256, and times it beside SDPA on
   the same and on zero-padded operands. The f32 instances are timed too:
   q4_matmul at the main path's eight shapes beside its plain version and
   cuBLAS f32 on the dequantized W, the fused attention at its three
   shapes beside SDPA in f32, the per-(batch, head) attention at
   rubert-tiny2's 2,048 bucket and the wide-head instance's 2x2x100 and
   4x8x512 at d_head 256 (each with the kernel's and the plain version's
   max|Δ| against an f64 product; the per-(batch, head) attention's bf16
   rows too); the router's sweep reports the threshold its measurement
   gives in each dtype. A kernel whose ptxas report shows a spill fails
   the build step;
3. main path: writes a MiniLM-L6 Q4_0 ggml file from seed 0, loads it with
   ``BertTorch.from_file(path)`` (the card, bf16) and answers a few
   mixed-length ``encode_batch`` requests — packed short sentences,
   bucketed sentences over 64 tokens, one of 512 tokens — with every
   kernel's launch count set to 0 just before and read just after; fails
   if a kernel of the path was not launched, or if the per-(batch, head)
   attention kernel was (d_head 32 takes the fused kernel); profiles one
   more request (device busy, the LayerNorm's time, the f32 -> bf16
   casts) and times its q4_matmul and attention calls bucket by bucket;
   fails unless the LayerNorm launched 2L + 1 times a batch; checks the
   result against the same file on the CPU in f32 (card f32: cos > 0.9999
   and atol 5e-3; card bf16: cos > 0.999); the card's f32 engine answers
   one request with the counts set to 0 just before and read just after
   (the f32 q4_matmul and fused attention must launch) and one more
   profiled (device busy, kernels, the two kernels' shares); then the
   API's switches on the
   same file: ``BertTorch.from_file(path, use_kernels=False)`` answers
   the same requests with the counts set to 0 just before and read just
   after, and fails if any of the eight counted kernels launched, or if a
   sentence's embedding has cos <= 0.999 against the default engine's, or
   if the default engine's counts for a request moved; both engines'
   device time is logged from a profiled request; the native tokenizer's
   ``tokenize_batch`` is timed at 1, 2, 4 and 8 threads and the auto
   default on one request (55 sentences) and on 2,750 sentences (ids
   unchanged at every count); ``read_ggml(path, mmap=False)`` must give
   the mmap reader's records, each parse timed;
4. hf_server path: writes a random-weight HF checkpoint directory at
   rubert-tiny2's published widths (D 312, 12 heads of 26, F 600, 3
   layers, vocab 83,828, 2,048 positions, CLS pooling) from seed 0, loads
   it with ``BertTorch.from_file(dir)``, warms it up and serves it with
   ``EmbeddingServer`` in-process; concurrent text clients, an EVAL frame,
   BATCH frames of a mixed request (packed rows, buckets, one sentence
   truncated into the 2,048 bucket), META and STATS2 go over the wire
   with the counts set to 0 just before and read just after; fails unless
   the per-(batch, head) attention and the LayerNorm kernels launched and
   the fused attention and Q4 kernels did not; holds every reply against
   a CPU f32 model on the same directory (cos > 0.999) and a card f32
   model against it (cos > 0.9999, max|Δ| ≤ 5e-3), with the counts set
   to 0 just before its request and read just after (the per-(batch,
   head) attention must launch); the same f32 request once more profiled
   (device busy, idle share, kernels, the f32 per-(batch, head)
   attention's share, its launches the counted request's);
5. int8_path: holds the W8A8 kernels (the activation quantization and the
   int8 matmul) to their plain versions bit for bit, in f32 and bf16, at
   bert-base's and MiniLM's four matmul shapes at M = 8,192 and at edge
   shapes (M = 1 and 37, N = 8 and 200, K = 1, 33, 312, 600 and 20,000, a
   zero row, rows of ±amax ties); times bert-base's four shapes beside
   ``torch._int_mm`` with the same epilogue, cuBLAS bf16 on the
   dequantized W and the bf16 q4_matmul; holds the folded forms bit for
   bit to their plain versions and to the unfolded composition (the
   LayerNorm's codes form, the matmul's form (c) with GELU) and times each
   beside its bound;
   writes a bert-base Q4_0 ggml file from seed 0 and loads it with
   ``BertTorch.from_file(path, int8_eval=True)``; each request holds 64
   sentences of 65-128 tokens (one 64x128 batch: 8,192 padded tokens, the
   int8 regime) and 8 short ones (one packed batch, Q4); fails unless each
   int8 batch launched int8_matmul 3L times, form (c) L times, the
   quantize kernel 2L times and the LayerNorm's codes form 2L times, and
   q4_matmul ran the packed one, and unless the profiled request shows no
   GELU or quantize of the int8 batch's QKV and FFN-up inputs; logs the
   rate beside the same requests with ``int8_eval=False``, profiles one
   request, and holds int8 against Q4 on the card (cos > 0.999) and the
   card's f32 int8 against the CPU's f32 int8 (cos > 0.9999, max|Δ| ≤
   5e-3);
   Every single-device engine of steps 3-5 runs each batch shape as one
   captured program (a CUDA graph, bert_tpu_torch/_graphs.py), and each
   warms its shapes before its counted requests: the main path by a warm
   pass over its requests (and ``warmup()`` of a fresh engine is timed
   with its peak memory), hf_server by ``warmup()`` and one warm BATCH
   frame, the int8 path by two warm requests. The graphs phase of the
   main path in bf16 and f32, of ``use_kernels=False``, of hf_server in
   bf16 and f32 and of the int8 path on and off fails if a program was
   captured inside the timed requests or a profile, if the forward
   programs are not the shapes ``stats()`` recorded, each with the regime
   the engine picks, if a program replayed on its static inputs differs
   by any bit from its function called eagerly on them, if the profiled
   request's kernels differ, name by name and count by count, from the
   same request run eagerly with the programs set aside (the parent's
   way), or if the profile's launches of a kernel differ from its
   counter's; it logs each path's request wall, dispatch phase, device
   busy, idle share and sentences/s;
6. train path: writes a MiniLM-L6 f32 ggml file from seed 0 whose vocab
   holds the words of benchmarks/data/sts_en.tsv, and fine-tunes it with
   ``python -m bert_tpu_torch.finetune``'s ``main`` on the card (20 steps
   of 32 pairs at seq 64, f32, remat) with every kernel's launch count
   set to 0 just before and read just after: training runs the plain
   versions, so any launch fails, as does a loss that does not fall or a
   step that is not finite; holds 3 steps at batch 8 on the card to the
   same steps on the CPU (loss, grad_norm, first moments, parameters);
   logs ms/step, pairs/s, tokens/s, the f32-peak share, peak memory with
   remat on and off, a bf16 step and a profiled step's device time by
   family; serves the tuned .npz on the card (bf16: the LayerNorm must
   launch 2L + 1 times a batch, the fused attention L times) and holds
   card f32 (cos > 0.9999, max|Δ| ≤ 5e-3) and bf16 (cos > 0.999) to the
   CPU;
7. sharded phase: 2 and 4 ranks spawned by
   ``bert_tpu_torch.parallel.multihost.spawn_ranks`` (on this one card:
   gloo, NCCL refusing two ranks on one card) run the main path's MiniLM-L6
   Q4_0 file at (dp, tp) = (1, 2), (2, 1) and (2, 2) and hf_server's
   rubert-tiny2 directory at (1, 2) through ``BertTorch.from_file(path,
   dp=, tp=)``, with the counts set to 0 just before and read just after
   on every rank; fails unless each rank launches q4_matmul at the shard
   shapes, the LayerNorm, and the fused attention over H/tp heads (MiniLM)
   or the per-(batch, head) attention over 6 heads (rubert-tiny2), and
   unless each rank's result agrees with the single rank's (bf16 cos >
   0.999; f32 cos > 0.9999, max|Δ| ≤ 5e-3); then 3 f32 fine-tune steps at
   (2, 2) against one rank's (loss, grad_norm, noise_rule). Each rank's
   device and wall time a request is logged as a time of the shared card;
8. prints one JSON line with each kernel's numbers, then as the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits non-zero before doing anything.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import socket
import statistics
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12,      # dense tensor-core rate
              "int8": 1979e12,     # dense int8 tensor-core rate (TOPS)
              "f32": 67e12}        # f32 outside the tensor cores (no TF32)

MINILM_L6 = dict(n_vocab=30522, n_max_tokens=512, n_embd=384,
                 n_intermediate=1536, n_head=12, n_layer=6)
# bert-base-uncased widths: the width bert_tpu names for the int8 regime
BERT_BASE = dict(n_vocab=30522, n_max_tokens=512, n_embd=768,
                 n_intermediate=3072, n_head=12, n_layer=12)
# cointegrated/rubert-tiny2, its published config.json: d_head = 312 / 12 =
# 26, outside the fused kernel's instances; 312 % 64 != 0, so dense weights
RUBERT_TINY2 = {"vocab_size": 83828, "max_position_embeddings": 2048,
                "hidden_size": 312, "intermediate_size": 600,
                "num_attention_heads": 12, "num_hidden_layers": 3,
                "hidden_act": "gelu", "layer_norm_eps": 1e-12,
                "type_vocab_size": 2, "model_type": "bert",
                "architectures": ["BertModel"]}

# the warmup grid's largest attention: max_batch 64 rows of rubert-tiny2's
# 2,048 bucket (B, H, T, d_head)
WARMUP_LARGEST = (64, 12, 2048, 26)

# atol = rtol per dtype, as tests/test_kernels_tpu.py states them. q4 in
# bf16 has no TPU-test tolerance; it gets 5e-2: the plain version rounds
# scale, min and product to bf16 one by one (as the jnp path does) where
# the kernel rounds the f32 weight once (as the Pallas kernel does), up to
# 2 bf16 ulps per weight, and the difference grows with sqrt(K) (Q4_1 at
# K=1024 measured 2.5e-2 on the card).
# multi_head_attention in bf16: 2e-2. Kernel and plain version both round
# p = exp(s - m) / l to bf16 once and the output once, but the kernel sums
# l tile by tile and takes the card's expf, so a p near a rounding
# boundary can land one bf16 ulp away (4e-3 at O(1)); measured 1 ulp of
# the output at every shape on the card (PERF.md).
# The int8 kernels are held to 0: their arithmetic is exact by
# construction (exact int32 sums, IEEE divisions, round half to even, two
# f32 products), so kernel and plain version agree bit for bit.
TOL = {"q4_matmul": {"f32": 1e-3, "bf16": 5e-2},
       "int8_matmul": {"f32": 0.0, "bf16": 0.0},
       "int8_matmul_gelu": {"f32": 0.0, "bf16": 0.0},
       "quantize_activations_i8": {"f32": 0.0, "bf16": 0.0},
       "fused_layer_norm_codes": {"f32": 0.0, "bf16": 0.0},
       "fused_qkv_attention": {"f32": 2e-4, "bf16": 2e-2},
       "fused_layer_norm": {"f32": 1e-4, "bf16": 3e-2},
       "multi_head_attention": {"f32": 1e-4, "bf16": 2e-2}}

REPLACES = {
    "q4_matmul": "bert_tpu/ops/q4_matmul.py:75 (_q4_matmul_kernel)",
    "fused_layer_norm": "bert_tpu/ops/layer_norm.py:42,50,58 "
                        "(_ln_kernel, _ln_res_kernel, _ln_res_pb_kernel)",
    "fused_qkv_attention": "bert_tpu/ops/fused_attention.py:43 "
                           "(_fused_attn_kernel)",
    "multi_head_attention": "bert_tpu/ops/attention.py:57 (_mha_kernel)",
    "int8_matmul": "bert_tpu/ops/int8_matmul.py:94 (int8_matmul; XLA in "
                   "bert_tpu, no Pallas kernel)",
    "quantize_activations_i8": "bert_tpu/ops/int8_matmul.py:83 "
                               "(quantize_activations_i8; XLA in bert_tpu, "
                               "no Pallas kernel)",
    "fused_layer_norm_codes": "bert_tpu/ops/layer_norm.py:42,50,58 "
                              "(_ln_kernel, _ln_res_kernel, "
                              "_ln_res_pb_kernel) + bert_tpu/ops/"
                              "int8_matmul.py:83 (quantize_activations_i8)",
    "int8_matmul_gelu": "bert_tpu/ops/int8_matmul.py:94 (int8_matmul) + "
                        "bert_tpu/model.py:158 (jax.nn.gelu)",
}
SOURCE = {"q4_matmul": "bert_tpu_torch/csrc/q4_matmul.cu",
          "fused_layer_norm": "bert_tpu_torch/csrc/layer_norm.cu",
          "fused_qkv_attention": "bert_tpu_torch/csrc/fused_attention.cu",
          "multi_head_attention": "bert_tpu_torch/csrc/attention.cu",
          "int8_matmul": "bert_tpu_torch/csrc/int8_matmul.cu",
          "int8_matmul_gelu": "bert_tpu_torch/csrc/int8_matmul.cu",
          "quantize_activations_i8": "bert_tpu_torch/csrc/int8_matmul.cu",
          "fused_layer_norm_codes": "bert_tpu_torch/csrc/layer_norm.cu"}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _median_window_ms(run, reps: int, rounds: int) -> float:
    import torch

    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def time_ms(fn, reps: int = 20, rounds: int = 7) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed ``rounds`` times between CUDA events; the median per call.
    The graph takes the host's launch cost out, so small kernels are timed
    by what the card does, not by how fast Python launches them. Inputs
    stay L2-resident across calls, as a layer's activations do."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_window_ms(graph.replay, reps, rounds)


def eager_ms(fn, reps: int = 20, rounds: int = 7) -> float:
    """Time of one call launched from Python (CUDA events around ``reps``
    eager calls): device time plus whatever the host's launch adds."""
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    return _median_window_ms(run, reps, rounds)


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, out, ref, dtype_name, what) -> float:
    import torch

    torch.cuda.synchronize()
    tol = TOL[name][dtype_name]
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    max_err = float(err.max())
    require(bool(torch.isfinite(out).all()), f"{name} {what}: non-finite")
    require(bool((err <= tol + tol * ref.abs()).all()),
            f"{name} {what}: max|Δ| {max_err:.3e} outside atol=rtol={tol}")
    log(f"  ok  {name:20s} {what:42s} max|Δ| {max_err:.3e} (tol {tol})")
    return max_err


def q4_weights(rng, k: int, n: int, ftype: int, dev):
    """A random [k, n] weight (scale 0.02) quantized to Q4_0 (ftype 2) or
    Q4_1 (3) in the group-local layout, on ``dev``."""
    import numpy as np
    import torch

    from bert_tpu_torch.quant import QuantTensor, quantize_tensor_tpu

    qt = quantize_tensor_tpu(
        (rng.standard_normal((k, n)) * 0.02).astype(np.float32), ftype)
    return QuantTensor(
        *(None if a is None else torch.from_numpy(a).to(dev)
          for a in (qt.packed, qt.scales, qt.mins)))


def attention_bias(rng, b: int, t: int, pairwise: bool):
    """An additive f32 bias with fully masked query rows. Pairwise: two
    halves of each row attend within themselves, and row 0's first
    quarter of queries sees no key. Key-side: random padding, the first
    key always live, and (for b > 1) the last batch row all padding."""
    import numpy as np

    if pairwise:
        halves = (np.arange(t) >= t // 2).astype(np.int32)
        same = halves[:, None] == halves[None, :]
        bias = np.where(same, 0.0, -1e9)[None].repeat(b, 0)
        bias[0, : max(1, t // 4)] = -1e9
    else:
        mask = (rng.random((b, t)) > 0.2).astype(np.float32)
        mask[:, 0] = 1.0
        if b > 1:
            mask[-1] = 0.0
        bias = (mask - 1.0) * 1e9
    return bias.astype(np.float32)


def split_bound(nbytes: float, flops: float):
    """The f32 instances' bound: the six bf16 products on the tensor
    cores (6x the f32 product's operations at the bf16 rate) or the bytes,
    whichever is larger; and, beside it, the f32 product's operations on
    the CUDA cores (67 TFLOP/s)."""
    b_ms, b_by = bound(nbytes, 6.0 * flops, "bf16")
    return b_ms, b_by, flops / PEAK_FLOPS["f32"] * 1e3


def q4_f32_timing(dev, rng):
    """The f32 instance at the main path's eight shapes (M 512 and 1,024
    x QKV, attention-out, FFN-up, FFN-down; Q4_0): the kernel by graph
    replay and eager, its plain version, and cuBLAS f32 on the
    pre-dequantized f32 W; each beside its bound. The kernel's and the
    plain version's max|Δ| against an f64 product of the same operands
    say how close each comes to exact."""
    import numpy as np
    import torch

    from bert_tpu_torch.ops import q4_matmul as Q

    rows = []
    for m in (512, 1024):
        for (k, n, what) in ((384, 1152, "QKV"), (384, 384, "attention-out"),
                             (384, 1536, "FFN-up"), (1536, 384, "FFN-down")):
            qd = q4_weights(rng, k, n, 2, dev)
            x = torch.from_numpy(
                rng.standard_normal((m, k)).astype(np.float32)).to(dev)
            w = Q.q4_dequantize(qd, torch.float32)
            exact = torch.matmul(x.double(), w.double())
            f64_err = {
                name: float((fn().double() - exact).abs().max())
                for name, fn in (("kernel", lambda: Q._launch(x, qd)),
                                 ("plain", lambda: Q.q4_matmul_plain(x, qd)))}
            nbytes = m * k * 4 + k // 2 * n + k // 32 * n * 4 + m * n * 4
            b_ms, b_by, simt_ms = split_bound(nbytes, 2.0 * m * n * k)
            r = dict(shape=f"M={m} K={k} N={n} q4_0 f32 ({what})",
                     ms=time_ms(lambda: Q.q4_matmul(x, qd)),
                     eager_ms=eager_ms(lambda: Q.q4_matmul(x, qd)),
                     plain_ms=time_ms(lambda: Q.q4_matmul_plain(x, qd)),
                     dense_f32_matmul_ms=time_ms(lambda: torch.matmul(x, w)),
                     bound_ms=b_ms, bound_by=b_by,
                     cuda_core_bound_ms=simt_ms,
                     kernel_f64_err=f64_err["kernel"],
                     plain_f64_err=f64_err["plain"])
            log(f"  {r['shape']}: kernel {r['ms']:.5f} ms (eager "
                f"{r['eager_ms']:.5f}), plain {r['plain_ms']:.5f}, cuBLAS "
                f"dense f32 {r['dense_f32_matmul_ms']:.5f}, bound "
                f"{b_ms:.5f} ({b_by}; CUDA cores {simt_ms:.5f}); max|Δ| "
                f"vs f64: kernel {f64_err['kernel']:.3e}, plain "
                f"{f64_err['plain']:.3e}")
            rows.append(r)
        torch.cuda.synchronize()
    return rows


def router_phase(dev, rng):
    """The q4 router's threshold on this card: the kernel against the
    plain dequantize-then-matmul at large M, at the QKV and FFN-up shapes,
    in bf16 (the card's compute type) and in f32."""
    import numpy as np
    import torch

    from bert_tpu_torch.ops import q4_matmul as Q

    log("q4_matmul router: kernel vs dequantize-then-matmul (graph replay)")
    rows = []
    for m in (1024, 2048, 4096, 8192, 16384):
        for (k, n, what) in ((384, 1152, "QKV"), (384, 1536, "FFN-up")):
            qd = q4_weights(rng, k, n, 2, dev)
            x32 = torch.from_numpy(
                rng.standard_normal((m, k)).astype(np.float32)).to(dev)
            for dn, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
                x = x32.to(dt)
                r = dict(M=m, K=k, N=n, what=what, dtype=dn,
                         kernel_ms=time_ms(lambda: Q._launch(x, qd), 10, 5),
                         plain_ms=time_ms(lambda: Q.q4_matmul_plain(x, qd),
                                          10, 5))
                log(f"  M={m} K={k} N={n} ({what}) {dn}: kernel "
                    f"{r['kernel_ms']:.5f} ms, plain {r['plain_ms']:.5f}")
                rows.append(r)
            del x, x32
            torch.cuda.synchronize()
    measured = {}
    for dn in ("bf16", "f32"):
        ms = sorted({r["M"] for r in rows})
        wins = [m for m in ms
                if all(r["kernel_ms"] < r["plain_ms"] for r in rows
                       if r["M"] == m and r["dtype"] == dn)]
        # the largest M up to which the kernel wins at every M measured
        # (the largest measured where it wins at all of them); None where
        # it loses at the smallest
        measured[dn] = None
        for m in ms:
            if m not in wins:
                break
            measured[dn] = m
        log(f"  {dn}: the kernel wins at both shapes for M in {wins}; "
            f"threshold by this run: {measured[dn]} (FUSED_MAX_M = "
            f"{Q.FUSED_MAX_M}, f32: {Q.FUSED_MAX_M_F32})")
    return {"rows": rows, "measured_max_m": measured,
            "FUSED_MAX_M": Q.FUSED_MAX_M,
            "FUSED_MAX_M_F32": Q.FUSED_MAX_M_F32}


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(dev, rng):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from bert_tpu_torch.ops import fused_attention as A
    from bert_tpu_torch.ops import layer_norm as L
    from bert_tpu_torch.ops import q4_matmul as Q

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    results = {}

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(dtype)

    # -- kernel 1: Q4 dequant-matmul --------------------------------------
    log("kernel 1: q4_matmul")
    q4_shapes = [(128, 384, 384), (512, 384, 1536), (200, 768, 768),
                 (2048, 1024, 4096), (1024, 384, 1152),
                 # edges: one row; N % 16 != 0 (4-byte band loads); N odd
                 # (byte-wide band, scalar stores); FFN-down's K = 1536
                 (1, 384, 200), (200, 1536, 200), (1, 1536, 384),
                 (37, 128, 201)]
    errs = {"f32": 0.0, "bf16": 0.0}

    def check_q4(x, qd, what):
        """The wrapper against the plain version; every shape here is at
        or under the router's threshold, so the wrapper must launch."""
        dn = "bf16" if x.dtype == torch.bfloat16 else "f32"
        before = Q.q4_matmul.launches
        out = Q.q4_matmul(x, qd)
        require(Q.q4_matmul.launches == before + 1,
                f"q4_matmul {what}: the wrapper did not launch the kernel")
        errs[dn] = max(errs[dn], compare("q4_matmul", out,
                                         Q.q4_matmul_plain(x, qd), dn, what))

    for (m, k, n) in q4_shapes:
        for ftype in (2, 3):
            qd = q4_weights(rng, k, n, ftype, dev)
            x32 = rng.standard_normal((m, k)).astype(np.float32)
            for dn, dt in dtypes.items():
                check_q4(t(x32, dt), qd,
                         f"M,K,N={m},{k},{n} q4_{ftype - 2} {dn}")
            torch.cuda.synchronize()

    # every shape of a MiniLM layer at the main path's M (1x512 bucket;
    # 16x64 packed rows and 8x128 bucket): QKV, attention-out, FFN-up,
    # FFN-down, each held against the plain version in both dtypes, then
    # timed in bf16 beside cuBLAS bf16 on the pre-dequantized W
    timed = []
    for m in (512, 1024):
        for (k, n, what) in ((384, 1152, "QKV"), (384, 384, "attention-out"),
                             (384, 1536, "FFN-up"), (1536, 384, "FFN-down")):
            qd = q4_weights(rng, k, n, 2, dev)
            x32 = rng.standard_normal((m, k)).astype(np.float32)
            check_q4(t(x32), qd, f"M,K,N={m},{k},{n} q4_0 f32 ({what})")
            x = t(x32, torch.bfloat16)
            check_q4(x, qd, f"M,K,N={m},{k},{n} q4_0 bf16 ({what})")
            w_dense = Q.q4_dequantize(qd, torch.bfloat16)
            nbytes = (m * k * 2 + k // 2 * n + k // 32 * n * 4 + m * n * 4)
            b_ms, b_by = bound(nbytes, 2.0 * m * n * k, "bf16")
            r = dict(shape=f"M={m} K={k} N={n} q4_0 bf16 ({what})",
                     ms=time_ms(lambda: Q.q4_matmul(x, qd)),
                     eager_ms=eager_ms(lambda: Q.q4_matmul(x, qd)),
                     plain_ms=time_ms(lambda: Q.q4_matmul_plain(x, qd)),
                     dense_bf16_matmul_ms=time_ms(
                         lambda: torch.matmul(x, w_dense)),
                     bound_ms=b_ms, bound_by=b_by)
            log(f"  {r['shape']}: kernel {r['ms']:.5f} ms (eager "
                f"{r['eager_ms']:.5f}), plain {r['plain_ms']:.5f}, cuBLAS "
                f"dense bf16 {r['dense_bf16_matmul_ms']:.5f}, bound "
                f"{b_ms:.5f} ({b_by})")
            timed.append(r)
    timed_f32 = q4_f32_timing(dev, rng)
    row = next(r for r in timed if r["shape"].startswith("M=1024 K=384 "
                                                          "N=1152"))
    results["q4_matmul"] = dict(
        row, shape=row["shape"].replace("(QKV)", "(MiniLM QKV)"),
        max_abs_err=errs["bf16"], max_abs_err_f32=errs["f32"],
        tolerance=TOL["q4_matmul"]["bf16"], library_ms=None,
        timed_shapes=timed, timed_shapes_f32=timed_f32,
        router=router_phase(dev, rng))

    # the router's other branch: M > fused_max_m(dtype) rows take the
    # plain dequantize-then-matmul on the card, and launch no kernel
    k, n = 384, 1536
    qd = q4_weights(rng, k, n, 2, dev)
    for dt in (torch.bfloat16, torch.float32):
        m = Q.fused_max_m(dt) + 8
        x = t(rng.standard_normal((m, k)).astype(np.float32), dt)
        before = Q.q4_matmul.launches
        routed = Q.q4_matmul(x, qd)
        torch.cuda.synchronize()
        # same computation twice; 1e-5 only allows cuBLAS another reduction
        require(Q.q4_matmul.launches == before
                and torch.allclose(routed, Q.q4_matmul_plain(x, qd),
                                   atol=1e-5, rtol=1e-5),
                f"q4_matmul router: M={m} {dt} did not take the plain branch")
        log(f"  ok  q4_matmul router     M={m} > {Q.fused_max_m(dt)} "
            f"{dt} took dequantize-then-matmul (no launch)")
        del routed, x

    # -- kernel 3: fused QKV attention -------------------------------------
    log("kernel 3: fused_qkv_attention")
    attn_shapes = [  # tests/test_kernels_tpu.py:50-60, the main path's,
        (16, 128, 12, 32, False), (8, 64, 12, 64, True),  # then ragged T
        (4, 512, 12, 32, False), (4, 512, 16, 64, False),
        (4, 512, 12, 64, False), (8, 64, 16, 64, True),
        (4, 512, 16, 32, False), (16, 64, 12, 32, True),
        (8, 128, 12, 32, False), (1, 512, 12, 32, False),
        (3, 37, 12, 32, True), (3, 37, 12, 32, False),
        (2, 100, 12, 64, True), (2, 100, 12, 64, False)]
    errs = {"f32": 0.0, "bf16": 0.0}
    for (b, s, h, dh, pairwise) in attn_shapes:
        qkv32 = rng.standard_normal((b, s, 3 * h * dh)).astype(np.float32)
        bias_t = t(attention_bias(rng, b, s, pairwise))
        kw = dict(n_head=h, d_head=dh, scale=1.0 / dh ** 0.5)
        for dn, dt in dtypes.items():
            qkv = t(qkv32, dt)
            err = compare(
                "fused_qkv_attention",
                A.fused_qkv_attention(qkv, bias_t, **kw),
                A.attention_plain(qkv, bias_t, **kw), dn,
                f"B,T,H,dh={b},{s},{h},{dh} "
                f"{'pairwise' if pairwise else 'key-side'} {dn}")
            errs[dn] = max(errs[dn], err)
        torch.cuda.synchronize()

    # the main path's three attention shapes, SDPA beside each
    timed = []
    for (b, s, h, dh, pairwise, what) in (
            (16, 64, 12, 32, True, "MiniLM packed rows"),
            (8, 128, 12, 32, False, "MiniLM 8x128 bucket"),
            (1, 512, 12, 32, False, "MiniLM 1x512 bucket")):
        d = h * dh
        qkv = t(rng.standard_normal((b, s, 3 * d)).astype(np.float32),
                torch.bfloat16)
        bias_t = t(attention_bias(rng, b, s, pairwise))
        scale = 1.0 / dh ** 0.5
        kw = dict(n_head=h, d_head=dh, scale=scale)
        q5 = qkv.view(b, s, h, 3, dh).permute(0, 2, 3, 1, 4)
        qh, kh, vh = q5[:, :, 0], q5[:, :, 1], q5[:, :, 2]
        mask4 = (bias_t[:, None] if pairwise
                 else bias_t[:, None, None, :]).to(torch.bfloat16)
        nbytes = b * s * 4 * d * 2 + bias_t.numel() * 4
        b_ms, b_by = bound(nbytes, 4.0 * b * h * s * s * dh, "bf16")
        form = "pairwise" if pairwise else "key-side"
        r = dict(shape=f"B={b} T={s} H={h} dh={dh} {form} bf16 ({what})",
                 ms=time_ms(lambda: A.fused_qkv_attention(qkv, bias_t, **kw)),
                 eager_ms=eager_ms(lambda: A.fused_qkv_attention(
                     qkv, bias_t, **kw)),
                 plain_ms=time_ms(lambda: A.attention_plain(qkv, bias_t,
                                                            **kw)),
                 library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, attn_mask=mask4, scale=scale)),
                 bound_ms=b_ms, bound_by=b_by)
        log(f"  {r['shape']}: kernel {r['ms']:.5f} ms (eager "
            f"{r['eager_ms']:.5f}), plain {r['plain_ms']:.5f}, sdpa "
            f"{r['library_ms']:.5f}, bound {b_ms:.5f} ({b_by})")
        timed.append(r)
    results["fused_qkv_attention"] = dict(
        timed[0], max_abs_err=errs["bf16"], max_abs_err_f32=errs["f32"],
        tolerance=TOL["fused_qkv_attention"]["bf16"], timed_shapes=timed,
        timed_shapes_f32=attention_f32_timing(dev, rng))

    results["fused_layer_norm"] = ln_kernel_phase(dev, rng)
    results["multi_head_attention"] = mha_kernel_phase(dev, rng)
    return results


def attention_f32_timing(dev, rng):
    """The fused attention's f32 instance at the main path's three
    shapes: the kernel by graph replay and eager, its plain version, and
    SDPA in f32 on the same operands (library_ms), each beside its bound.
    The kernel's and the plain version's max|Δ| against the same attention
    in f64, over the query rows that have a live key (a fully masked row
    is uniform only where -1e9 swamps the scores, as it does in f32)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from bert_tpu_torch.ops import fused_attention as A

    rows = []
    for (b, s, h, dh, pairwise, what) in (
            (16, 64, 12, 32, True, "MiniLM packed rows"),
            (8, 128, 12, 32, False, "MiniLM 8x128 bucket"),
            (1, 512, 12, 32, False, "MiniLM 1x512 bucket")):
        d = h * dh
        qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * d)).astype(
            np.float32)).to(dev)
        bias = attention_bias(rng, b, s, pairwise)
        bias_t = torch.from_numpy(bias).to(dev)
        scale = 1.0 / dh ** 0.5
        kw = dict(n_head=h, d_head=dh, scale=scale)
        q5 = qkv.view(b, s, h, 3, dh).permute(0, 2, 3, 1, 4)
        mask4 = bias_t[:, None] if pairwise else bias_t[:, None, None, :]
        live = torch.from_numpy((bias == 0).any(-1) if pairwise else
                                np.repeat((bias == 0).any(-1)[:, None], s,
                                          1)).to(dev)
        q64 = qkv.double().view(b, s, h, 3, dh).permute(0, 2, 3, 1, 4)
        p64 = torch.softmax(torch.matmul(
            q64[:, :, 0], q64[:, :, 1].transpose(-1, -2)) * scale
            + mask4.double(), dim=-1)
        exact = torch.matmul(p64, q64[:, :, 2]).permute(0, 2, 1, 3).reshape(
            b, s, d)
        f64_err = {
            name: float((fn().double() - exact)[live].abs().max())
            for name, fn in (
                ("kernel", lambda: A.fused_qkv_attention(qkv, bias_t, **kw)),
                ("plain", lambda: A.attention_plain(qkv, bias_t, **kw)))}
        nbytes = b * s * 4 * d * 4 + bias_t.numel() * 4
        b_ms, b_by, simt_ms = split_bound(nbytes, 4.0 * b * h * s * s * dh)
        form = "pairwise" if pairwise else "key-side"
        r = dict(shape=f"B={b} T={s} H={h} dh={dh} {form} f32 ({what})",
                 ms=time_ms(lambda: A.fused_qkv_attention(qkv, bias_t, **kw)),
                 eager_ms=eager_ms(lambda: A.fused_qkv_attention(
                     qkv, bias_t, **kw)),
                 plain_ms=time_ms(lambda: A.attention_plain(qkv, bias_t,
                                                            **kw)),
                 library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                     q5[:, :, 0], q5[:, :, 1], q5[:, :, 2], attn_mask=mask4,
                     scale=scale)),
                 bound_ms=b_ms, bound_by=b_by, cuda_core_bound_ms=simt_ms,
                 kernel_f64_err=f64_err["kernel"],
                 plain_f64_err=f64_err["plain"])
        log(f"  {r['shape']}: kernel {r['ms']:.5f} ms (eager "
            f"{r['eager_ms']:.5f}), plain {r['plain_ms']:.5f}, sdpa f32 "
            f"{r['library_ms']:.5f}, bound {b_ms:.5f} ({b_by}; CUDA cores "
            f"{simt_ms:.5f}); max|Δ| vs f64 (live rows): kernel "
            f"{f64_err['kernel']:.3e}, plain {f64_err['plain']:.3e}")
        rows.append(r)
    return rows


def ln_kernel_phase(dev, rng):
    """Kernel 2, the LayerNorm, each shape held against the plain version
    through the public wrapper in f32 and bf16, with a launch-count check:
    the shapes of tests/test_kernels_tpu.py:122-130; the paths' own (main:
    1,024 and 512 rows of D 384; hf_server: 2,048 and 512 rows of D 312),
    with the residual and pre-bias and in the plain (embedding) form; the
    edges (M = 1; D = 130, the 4-byte path; D = 129, the scalar path; D =
    1,280 and 4,096, past a row in registers, on the block-per-row
    instance); and the f32-input form (f32 x, bf16 residual and output) at
    1024x384 and 2048x312, held against ``layer_norm_plain(x.to(bf16))``.
    Every path shape is timed in bf16 (graph replay, eager beside it) with
    its bound and the plain version, the plain form beside
    ``F.layer_norm`` and the f32-input form beside cast + kernel. The
    1024x384 +res+pre_bias shape is the kernel's row in the JSON line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from bert_tpu_torch.ops import layer_norm as L

    log("kernel 2: fused_layer_norm")
    bf16 = torch.bfloat16
    errs = {"f32": 0.0, "bf16": 0.0}

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(dtype)

    def operands(m, d, form, x_dtype, out_dtype):
        x = t(rng.standard_normal((m, d)).astype(np.float32), x_dtype)
        r = (t(rng.standard_normal((m, d)).astype(np.float32), out_dtype)
             if form != "plain" else None)
        p = (t(rng.standard_normal(d).astype(np.float32))
             if form == "+res+pre_bias" else None)
        sc, bi = (t(rng.standard_normal(d).astype(np.float32))
                  for _ in range(2))
        return dict(x=x, scale=sc, bias=bi, residual=r, pre_bias=p)

    def kernel(o, out_dtype=None):
        return L.fused_layer_norm(o["x"], o["scale"], o["bias"], eps=1e-12,
                                  residual=o["residual"],
                                  pre_bias=o["pre_bias"],
                                  out_dtype=out_dtype)

    def plain(o, out_dtype=None):
        return L.layer_norm_plain(o["x"].to(out_dtype or o["x"].dtype),
                                  o["scale"], o["bias"], 1e-12,
                                  o["residual"], o["pre_bias"])

    def check(o, what, out_dtype=None):
        dn = "f32" if (out_dtype or o["x"].dtype) == torch.float32 else "bf16"
        before = L.fused_layer_norm.launches
        out = kernel(o, out_dtype)
        require(L.fused_layer_norm.launches == before + 1,
                f"fused_layer_norm {what}: the wrapper did not launch the "
                "kernel")
        err = compare("fused_layer_norm", out, plain(o, out_dtype), dn, what)
        errs[dn] = max(errs[dn], err)
        return err

    def timing(o, m, d, form, what, out_dtype=None):
        x = o["x"]
        out_size = (out_dtype or x.dtype).itemsize
        rows = m * d * (x.element_size() + out_size
                        + (out_size if o["residual"] is not None else 0))
        params = d * 4 * (3 if o["pre_bias"] is not None else 2)
        b_ms, b_by = bound(rows + params, 12.0 * m * d, "f32")
        fdt = "f32->bf16" if out_dtype is not None else "bf16"
        r = dict(shape=f"M={m} D={d} {form} {fdt} ({what})",
                 ms=time_ms(lambda: kernel(o, out_dtype)),
                 eager_ms=eager_ms(lambda: kernel(o, out_dtype)),
                 plain_ms=time_ms(lambda: plain(o, out_dtype)),
                 library_ms=None, bound_ms=b_ms, bound_by=b_by)
        if form == "plain":  # one PyTorch call computes the plain form
            sc, bi = o["scale"].to(x.dtype), o["bias"].to(x.dtype)
            r["library_ms"] = time_ms(lambda: F.layer_norm(
                x, (d,), sc, bi, 1e-12))
        if out_dtype is not None:  # what the model launched before: 2 calls
            r["cast_plus_kernel_ms"] = time_ms(lambda: L.fused_layer_norm(
                x.to(out_dtype), o["scale"], o["bias"], eps=1e-12,
                residual=o["residual"], pre_bias=o["pre_bias"]))

        def fmt(k):
            return "none" if r.get(k) is None else f"{r[k]:.5f}"
        log(f"  {r['shape']}: kernel {r['ms']:.5f} ms (eager "
            f"{r['eager_ms']:.5f}), plain {r['plain_ms']:.5f}, F.layer_norm "
            f"{fmt('library_ms')}, cast + kernel "
            f"{fmt('cast_plus_kernel_ms')}, bound {b_ms:.5f} ({b_by})")
        return r

    # (M, D, form, what it is; "" = checked, not timed)
    shapes = [  # tests/test_kernels_tpu.py:122-130
        (2048, 384, "plain", ""), (2048, 384, "+res", ""),
        (1024, 768, "+res+pre_bias", ""),
        (12288, 1024, "+res+pre_bias", ""),
        # the main path: 16x64 packed and 8x128 (1,024 rows), 1x512
        (1024, 384, "+res+pre_bias", "MiniLM post-projection LN"),
        (1024, 384, "plain", "MiniLM embedding LN"),
        (512, 384, "+res+pre_bias", "MiniLM 1x512 bucket"),
        (512, 384, "plain", "MiniLM 1x512 embedding LN"),
        # hf_server: 1x2048, 4x512, 32x64 packed (2,048 rows); 2x256, 4x128
        (2048, 312, "+res+pre_bias", "rubert-tiny2 2,048 rows"),
        (2048, 312, "plain", "rubert-tiny2 embedding LN"),
        (512, 312, "+res+pre_bias", "rubert-tiny2 512 rows"),
        (512, 312, "plain", "rubert-tiny2 512-row embedding LN"),
        # edges: one row, the 4-byte and scalar paths, block-per-row
        (1, 384, "+res+pre_bias", ""), (1, 384, "plain", ""),
        (37, 130, "+res+pre_bias", ""), (37, 129, "+res+pre_bias", ""),
        (256, 1280, "+res+pre_bias", "block per row"),
        (64, 4096, "+res+pre_bias", "block per row")]
    timed, row = [], None
    for (m, d, form, what) in shapes:
        for dn, dt in (("f32", torch.float32), ("bf16", bf16)):
            o = operands(m, d, form, dt, dt)
            err = check(o, f"M,D={m},{d} {form} {dn}")
            if dn == "bf16" and what:
                r = timing(o, m, d, form, what)
                r["max_abs_err"] = err
                timed.append(r)
                if (m, d, form) == (1024, 384, "+res+pre_bias"):
                    row = r
        torch.cuda.synchronize()
    # the f32-input form: a matmul's f32 product, rounded to bf16 first
    for (m, d, what) in ((1024, 384, "MiniLM post-projection LN"),
                         (2048, 312, "rubert-tiny2 2,048 rows")):
        o = operands(m, d, "+res+pre_bias", torch.float32, bf16)
        err = check(o, f"M,D={m},{d} +res+pre_bias f32 x -> bf16", bf16)
        r = timing(o, m, d, "+res+pre_bias", what, bf16)
        r["max_abs_err"] = err
        timed.append(r)
        torch.cuda.synchronize()

    plain_form = next(r for r in timed
                      if r["shape"].startswith("M=1024 D=384 plain"))
    return dict(row, max_abs_err=errs["bf16"], max_abs_err_f32=errs["f32"],
                tolerance=TOL["fused_layer_norm"]["bf16"],
                plain_form_ms=plain_form["ms"],
                plain_form_library_ms=plain_form["library_ms"],
                timed_shapes=timed)


def mha_kernel_phase(dev, rng):
    """Kernel 4, the per-(batch, head) attention, each shape held against
    the plain version through the public wrapper in f32 and bf16, with a
    launch-count check: the shapes of tests/test_kernels_tpu.py:101-117 and
    the hf_server path's (d_head 26: bucketed rows at 512, the 2,048
    bucket, packed rows with their pairwise bias), timed in bf16; ragged T
    (1, 37, 100, 2,047) against the 64-key tiles and head dims 1-128 (every
    copy path and instance), each in both bias forms with fully masked
    rows; head dims 136, 192 and 256 (the instance above 128), the same
    way, 2x2x100 at 256 timed, and 4x8x512 at 256 held and timed in both
    types; and the warmup grid's largest shape,
    64x12x2048 at d_head 26, timed. Beside each timed bf16 shape: SDPA on
    the same operands (library_ms) and, where d_head % 8 != 0, SDPA on q,
    k, v zero-padded to the next multiple of 8 beforehand
    (library_padded_ms), which reaches SDPA's fused kernels. The f32
    instance is timed at the 2,048 bucket and at both wide shapes, and
    every timed shape but the largest carries the kernel's and the plain
    version's max|Δ| against the same attention in f64. The path's 2,048
    bucket is the kernel's row in the JSON line."""
    import numpy as np
    import torch

    from bert_tpu_torch.ops import attention as M

    log("kernel 4: multi_head_attention")
    dtypes = (("f32", torch.float32), ("bf16", torch.bfloat16))
    errs = {"f32": 0.0, "bf16": 0.0}

    def operands(b, h, t, dh, dt):
        return [torch.from_numpy(rng.standard_normal((b, h, t, dh)).astype(
            np.float32)).to(dev).to(dt) for _ in range(3)]

    def check(q, k, v, bias_t, scale, what, chunk=None):
        """The wrapper against the plain version (in batch chunks where the
        plain version's [T, T] scores would not fit at once)."""
        dn = "bf16" if q.dtype == torch.bfloat16 else "f32"
        before = M.multi_head_attention.launches
        out = M.multi_head_attention(q, k, v, bias_t, scale=scale)
        require(M.multi_head_attention.launches == before + 1,
                f"multi_head_attention {what}: the wrapper did not launch "
                "the kernel")
        step, err = chunk or q.shape[0], 0.0
        for i in range(0, q.shape[0], step):
            sl = slice(i, i + step)
            tag = what if chunk is None else f"{what} rows {i}..{i + step}"
            err = max(err, compare(
                "multi_head_attention", out[sl],
                M._mha_plain(q[sl], k[sl], v[sl], bias_t[sl], scale), dn,
                tag))
        errs[dn] = max(errs[dn], err)
        return err

    # the test_kernels_tpu.py and hf_server shapes, timed in bf16
    shapes = [(4, 12, 512, 32, False), (2, 16, 512, 64, False),
              (8, 12, 512, 26, False), (1, 12, 2048, 26, False),
              (16, 12, 64, 26, True)]
    timed, timed_f32, row = [], [], None
    for (b, h, t, dh, pairwise) in shapes:
        q32, k32, v32 = (rng.standard_normal((b, h, t, dh)).astype(np.float32)
                         for _ in range(3))
        if pairwise:  # packed rows: 4 segments of 16, the last of row 0 pad
            seg = (np.arange(t) // 16 + 1)[None].repeat(b, 0)
            seg[0, -16:] = 0
            same = seg[:, :, None] == seg[:, None, :]
            bias = np.where(same & (seg > 0)[:, None, :], 0.0, -1e9)
        else:
            mask = (rng.random((b, t)) > 0.2).astype(np.float32)
            mask[:, 0] = 1.0
            bias = (mask - 1.0) * 1e9
        bias_t = torch.from_numpy(bias.astype(np.float32)).to(dev)
        scale = 1.0 / dh ** 0.5
        form = "pairwise" if pairwise else "key-side"
        for dn, dt in dtypes:
            q, k, v = (torch.from_numpy(a).to(dev).to(dt)
                       for a in (q32, k32, v32))
            err = check(q, k, v, bias_t, scale,
                        f"B,H,T,dh={b},{h},{t},{dh} {form} {dn}")
            if dn != "bf16":
                if (b, h, t, dh, pairwise) == (1, 12, 2048, 26, False):
                    r = mha_timing(q, k, v, bias_t, scale, pairwise)
                    r["max_abs_err"] = err
                    timed_f32.append(r)
                continue
            r = mha_timing(q, k, v, bias_t, scale, pairwise)
            r["max_abs_err"] = err
            timed.append(r)
            if (b, h, t, dh, pairwise) == (1, 12, 2048, 26, False):
                row = dict(r)
        torch.cuda.synchronize()

    # ragged T against the 64-key tiles, then head dims 1..128: every copy
    # path (16-byte, 4-byte, element) and every instance (DH 32, 64, 128);
    # attention_bias leaves fully masked query rows in both forms
    edge = ([(3, 4, t, 26) for t in (1, 37, 100)] + [(2, 4, 2047, 26)]
            + [(2, 3, 100, dh) for dh in (1, 13, 26, 48, 80, 128)])
    for (b, h, t, dh) in edge:
        for pairwise in (False, True):
            bias_t = torch.from_numpy(attention_bias(rng, b, t,
                                                     pairwise)).to(dev)
            form = "pairwise" if pairwise else "key-side"
            for dn, dt in dtypes:
                q, k, v = operands(b, h, t, dh, dt)
                check(q, k, v, bias_t, 1.0 / dh ** 0.5,
                      f"B,H,T,dh={b},{h},{t},{dh} {form} {dn} (edge)")
        torch.cuda.synchronize()

    # head dims above 128: the wide-head instance, both bias forms (each
    # with fully masked rows), one shape timed
    for dh in (136, 192, 256):
        for pairwise in (False, True):
            bias_t = torch.from_numpy(attention_bias(rng, 2, 100,
                                                     pairwise)).to(dev)
            form = "pairwise" if pairwise else "key-side"
            for dn, dt in dtypes:
                q, k, v = operands(2, 2, 100, dh, dt)
                err = check(q, k, v, bias_t, 1.0 / dh ** 0.5,
                            f"B,H,T,dh=2,2,100,{dh} {form} {dn} (wide head)")
                if (dh, pairwise) == (256, False):
                    r = mha_timing(q, k, v, bias_t, 1.0 / dh ** 0.5, False)
                    r["max_abs_err"] = err
                    r["shape"] += " (wide-head instance)"
                    (timed if dn == "bf16" else timed_f32).append(r)
        torch.cuda.synchronize()
    # and one where the card does real work: 4x8x512 at d_head 256
    b, h, t, dh = 4, 8, 512, 256
    mask = (rng.random((b, t)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    bias_t = torch.from_numpy(((mask - 1.0) * 1e9).astype(np.float32)).to(dev)
    for dn, dt in dtypes:
        q, k, v = operands(b, h, t, dh, dt)
        err = check(q, k, v, bias_t, dh ** -0.5,
                    f"B,H,T,dh={b},{h},{t},{dh} key-side {dn} (wide head)")
        r = mha_timing(q, k, v, bias_t, dh ** -0.5, False)
        r["max_abs_err"] = err
        r["shape"] += " (wide-head instance)"
        (timed if dn == "bf16" else timed_f32).append(r)
        torch.cuda.synchronize()

    # the warmup grid's largest shape: 64 rows of the 2,048 bucket
    b, h, t, dh = WARMUP_LARGEST
    mask = (rng.random((b, t)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    bias_t = torch.from_numpy(((mask - 1.0) * 1e9).astype(np.float32)).to(dev)
    for dn, dt in dtypes:
        q, k, v = operands(b, h, t, dh, dt)
        err = check(q, k, v, bias_t, dh ** -0.5,
                    f"B,H,T,dh={b},{h},{t},{dh} key-side {dn}", chunk=16)
        if dn == "bf16":
            r = mha_timing(q, k, v, bias_t, dh ** -0.5, False, large=True)
            r["max_abs_err"] = err
            timed.append(r)
        del q, k, v
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    row["shape"] += " (rubert-tiny2's 2048 bucket)"
    row["max_abs_err"] = errs["bf16"]
    row["max_abs_err_f32"] = errs["f32"]
    row["shapes"] = timed
    row["shapes_f32"] = timed_f32
    return row


def mha_timing(q, k, v, bias_t, scale, pairwise, large=False):
    """One shape of kernel 4 timed (bf16, or f32: the bound then that of
    split_bound): the kernel (graph replay, and its eager time), the plain
    version, SDPA on the same operands and, where d_head % 8 != 0, SDPA on
    operands zero-padded to the next multiple of 8 beforehand. ``large``:
    the yardsticks (whose [T, T] intermediates take tens of GB) are timed
    eagerly over 2 calls, which their milliseconds make exact enough, and
    a yardstick that runs out of memory is recorded as not measured
    (None). Other shapes also carry the kernel's and the plain version's
    max|Δ| against the same attention in f64, over the query rows that
    have a live key (a fully masked row is uniform only where -1e9 swamps
    the scores, as it does in f32)."""
    import torch
    import torch.nn.functional as F

    from bert_tpu_torch.ops import attention as M

    b, h, t, dh = q.shape
    bias4 = (bias_t[:, None] if pairwise
             else bias_t[:, None, None, :]).to(q.dtype)
    nbytes = 4 * q.numel() * q.element_size() + bias_t.numel() * 4
    flops = 4.0 * b * h * t * t * dh
    dn = "bf16" if q.dtype == torch.bfloat16 else "f32"
    b_ms, b_by, simt_ms = ((*bound(nbytes, flops, "bf16"), None)
                           if dn == "bf16" else split_bound(nbytes, flops))
    dp = -(-dh // 8) * 8
    padded = ([F.pad(x, (0, dp - dh)) for x in (q, k, v)] if dp != dh
              else None)

    def yardstick(fn):
        if not large:
            return time_ms(fn)
        try:
            return eager_ms(fn, reps=2, rounds=3)
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            return None

    form = "pairwise" if pairwise else "key-side"
    r = dict(
        shape=f"B={b} H={h} T={t} dh={dh} {form} {dn}",
        tolerance=TOL["multi_head_attention"][dn],
        ms=time_ms(lambda: M.multi_head_attention(q, k, v, bias_t,
                                                  scale=scale)),
        eager_ms=eager_ms(lambda: M.multi_head_attention(
            q, k, v, bias_t, scale=scale)),
        plain_ms=yardstick(lambda: M._mha_plain(q, k, v, bias_t, scale)),
        library_ms=yardstick(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias4, scale=scale)),
        library_padded_ms=None if padded is None else yardstick(
            lambda: F.scaled_dot_product_attention(
                *padded, attn_mask=bias4, scale=scale)),
        bound_ms=b_ms, bound_by=b_by)
    if simt_ms is not None:
        r["cuda_core_bound_ms"] = simt_ms
    f64 = ""
    if not large:
        exact = torch.matmul(torch.softmax(
            torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
            + bias4.double(), dim=-1), v.double())
        live = (bias_t == 0).any(-1)  # [B] key-side, [B, T] pairwise
        live = (live[:, None, None] if not pairwise else live[:, None, :])
        live = live.expand(b, h, t)
        for name, out in (("kernel", M.multi_head_attention(
                q, k, v, bias_t, scale=scale)),
                ("plain", M._mha_plain(q, k, v, bias_t, scale))):
            r[f"{name}_f64_err"] = float(
                (out.double() - exact)[live].abs().max())
        f64 = (f"; max|Δ| vs f64 (live rows): kernel "
               f"{r['kernel_f64_err']:.3e}, plain {r['plain_f64_err']:.3e}")
        del exact

    def fmt(x):
        return "not measured" if x is None else f"{x:.5f}"
    log(f"  {r['shape']}: kernel {r['ms']:.5f} ms (eager "
        f"{r['eager_ms']:.5f}), plain {fmt(r['plain_ms'])}, sdpa "
        f"{fmt(r['library_ms'])}, sdpa padded to dh {dp} "
        f"{fmt(r['library_padded_ms'])}, bound {b_ms:.5f} ({b_by}"
        + ("" if simt_ms is None else f"; CUDA cores {simt_ms:.5f}") + ")"
        + f64)
    return r


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

# word → id in the bert-base-uncased vocab; the rest of the 30522 slots are
# "[unusedN]" placeholders the tokenizer never produces
_WORDS = {
    "going": 2183, "to": 2000, "the": 1996, "store": 3573, "buy": 4965,
    "apples": 18108, "and": 1998, "banana": 15212, "you": 2017,
    "welcome": 6160, "come": 2272, "along": 2247, "if": 2065, "like": 2066,
    "time": 2051, "is": 2003, "it": 2009, "partly": 6576, "cloudy": 24706,
    "outside": 2648, "be": 2022, "back": 2067, "soon": 2574, "so": 2061,
    "go": 2175, "anywhere": 5973, "stack": 9991, "top": 2327,
    "calculate": 18422, "operator": 6872, "return": 2709, "push": 5245,
    "pop": 3769, "evaluate": 16157, "expression": 3670, "for": 2005,
    "else": 2842, "result": 2765, "input": 7953, "quebec": 5447,
}
_SPECIALS = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102,
             "[MASK]": 103, ".": 1012, ",": 1010}


def fixture_tokens(n_vocab: int):
    tokens = [f"[unused{i}]" for i in range(n_vocab)]
    for tok, i in {**_SPECIALS, **_WORDS}.items():
        tokens[i] = tok
    return tokens


def request_corpus(rng):
    """One request's sentences: 48 short (packed), 6 over 64 tokens
    (bucketed at 128), and one truncated to the 512-token bucket."""
    words = sorted(_WORDS)

    def sentence(n):
        return " ".join(rng.choice(words, size=n)) + "."

    short = [sentence(int(n)) for n in rng.integers(4, 25, size=48)]
    long = [sentence(int(n)) for n in rng.integers(70, 121, size=6)]
    return short + long + [sentence(700)]


def profile_request(model, request, path: str, extra=()):
    """Where one request's time goes: device time by kernel (torch.profiler,
    CUDA activity) against the request's wall time, with the LayerNorm's
    kernels, the f32 -> bf16 casts (PyTorch's bfloat16_copy_kernel) and each
    ``extra`` (label, kernel names) family summed apart. Run after the
    counted requests, so its launches are not part of their counts. Returns
    the sums (None where the profiler saw no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.encode_batch(request)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        log(f"{path} profile: device time not measured (the profiler saw no "
            "CUDA kernel time)")
        return None

    def family(*names):
        # a name, or a tuple of names that must all be in the kernel's
        hit = [e for e in kernels
               if any(all(p in e.key for p in ((n,) if isinstance(n, str)
                                               else n)) for n in names)]
        return (sum(e.self_device_time_total for e in hit),
                sum(e.count for e in hit))
    ln_us, ln_n = family("ln_rows_kernel", "ln_block_kernel")
    cast_us, cast_n = family("bfloat16_copy_kernel")
    n_kernels = sum(e.count for e in kernels)
    log(f"{path} profile of one request: wall {wall_us:.1f} us (profiled), "
        f"device busy {busy_us:.1f} us = {100 * busy_us / wall_us:.1f}% "
        f"(idle {100 - 100 * busy_us / wall_us:.1f}%) in {n_kernels} "
        f"kernels; LayerNorm {ln_us:.1f} us / {ln_n} launches; bf16 casts "
        f"{cast_us:.1f} us / {cast_n}")
    sums = {}
    for label, names in extra:
        us, n = family(*names)
        sums[f"{label}_us"], sums[f"{label}_launches"] = us, n
        log(f"  {label}: {us:.1f} us / {n} launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total:10.1f} us {e.count:5d}x  "
            f"{e.key[:100]}")
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "by_name": {e.key: e.count for e in kernels},
            "kernels": n_kernels, "layer_norm_us": ln_us,
            "layer_norm_launches": ln_n, "bf16_cast_us": cast_us,
            "bf16_casts": cast_n, **sums}


# ---------------------------------------------------------------------------
# graphs: one captured program per batch shape
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def programs_set_aside(model):
    """The engine with its programs set aside: every op launched from
    Python, as the engine ran before it captured (and as a mesh engine
    runs). For the eager side of a comparison only."""
    saved, model._programs = model._programs, None
    try:
        yield
    finally:
        model._programs = saved


AB_ROUNDS = 5  # rounds of the same request, replayed then eager


def n_programs(model) -> int:
    return len(model._programs.table)


def timed_start(model) -> dict:
    """A timed window's start: the engine's program count and its phase
    totals (tokenize, dispatch, gather; seconds, unrounded)."""
    return {"programs_before": n_programs(model),
            "phases_before": dict(model.timers.totals)}


def timed_end(model, timed: dict, latency_s, sentences: int) -> dict:
    before = timed.pop("phases_before")
    timed.update(latency_s=latency_s, sentences=sentences, phases_s={
        k: v - before.get(k, 0.0) for k, v in model.timers.totals.items()})
    return timed


def graphs_phase(model, label: str, request, prof, timed: dict,
                 exact: bool = True) -> dict:
    """The graphs phase of one engine, after its warm and timed requests
    (``timed``, from :func:`timed_start` and :func:`timed_end`: the timed
    requests' latencies, sentences and phase seconds, and the program
    count before them):

    (a) no capture inside the timed requests: the program count did not
        move, and the forward programs' (rows, T, kind) are the shapes the
        engine's ``stats()`` recorded (``exact``), or hold them (a grid
        warmup captured more), each with the regime ``_model_for`` picks;
    (b) every program, replayed on its static inputs, equals its function
        called eagerly on the same inputs, bit for bit;
    (c) the profiled request ``prof`` (the programs replayed) ran the same
        kernels, name by name and count by count, as the same request run
        eagerly with the programs set aside, which is how the parent ran
        it; and no program was captured by either profile.

    Logs the request wall, the engine's phases a request (tokenize,
    dispatch, gather), device busy, idle share and sentences/s beside the
    card's name and power limit."""
    import torch

    progs = model._programs.table
    require(n_programs(model) == timed["programs_before"],
            f"graphs, {label}: {n_programs(model) - timed['programs_before']}"
            " programs captured inside the timed requests")
    fwd = {k for k in progs if len(k) == 4}
    kinds = {(r, t, "packed" if kind == "packed" else "")
             for r, t, kind, _ in fwd}
    seen = set(model.timers.bucket_counts)
    require(kinds == seen if exact else kinds >= seen,
            f"graphs, {label}: forward programs {sorted(kinds)}, stats() "
            f"shapes {sorted(seen)}")
    for r, t, kind, regime in fwd:
        require(regime == model._regime(model._model_for(r * t)),
                f"graphs, {label}: program {(r, t, kind)} has regime "
                f"{regime}")
    require(len(fwd) == len(kinds), f"graphs, {label}: a shape has two "
            "regimes")
    gathers = [k for k in progs if len(k) == 5]
    require(all(k[:4] in fwd and k[4] % 256 == 0 for k in gathers),
            f"graphs, {label}: gather programs {gathers}")

    if prof is not None:
        kernels_agree_with_counters(model, label, request, prof)

    worst, differ = 0.0, []
    with torch.inference_mode():
        for key, prog in progs.items():
            prog.replay()
            got = prog.output.float().clone()
            want = prog.fn(**prog.inputs).float()
            d = float((got - want).abs().max()) if got.numel() else 0.0
            worst = max(worst, d)
            if d:
                differ.append((key, d))
        torch.cuda.synchronize()
    log(f"graphs, {label}: {len(progs)} programs ({len(fwd)} forward, "
        f"{len(gathers)} gathers), each replayed on its static inputs vs "
        f"its function called eagerly: max|Δ| {worst:.3e}"
        + (f"; differing: {differ}" if differ else ", bit for bit"))
    require(not differ, f"graphs, {label}: a replay differs from its "
            f"function run eagerly: {differ}")

    with programs_set_aside(model):
        eager = profile_request(model, request, f"{label}, eager (programs "
                                "set aside)")
    # the same request replayed and eager (the parent's way), in turns
    walls = {"replayed": [], "eager": []}
    phases = {"replayed": {}, "eager": {}}
    for _ in range(AB_ROUNDS):
        for way in ("replayed", "eager"):
            with (programs_set_aside(model) if way == "eager"
                  else contextlib.nullcontext()):
                before = dict(model.timers.totals)
                t0 = time.perf_counter()
                model.encode_batch(request)
                walls[way].append(time.perf_counter() - t0)
                for k, v in model.timers.totals.items():
                    phases[way][k] = (phases[way].get(k, 0.0) + (
                        v - before.get(k, 0.0)) / AB_ROUNDS * 1e3)
    require(n_programs(model) == timed["programs_before"],
            f"graphs, {label}: a profiled request captured a program")
    lat = timed["latency_s"]
    out = {"programs": len(progs), "forward_programs": len(fwd),
           "gathers": len(gathers), "replay_max_abs_err": worst,
           "request_wall_ms": statistics.median(lat) * 1e3,
           "phase_ms_per_request": {k: v / len(lat) * 1e3 for k, v in
                                    timed["phases_s"].items()},
           "sentences_per_s": timed["sentences"] / sum(lat),
           "same_request_ms": {w: statistics.median(v) * 1e3
                               for w, v in walls.items()},
           "same_request_phase_ms": phases}
    if prof is not None and eager is not None:
        def names(p):
            # the profiler names a memset node of a graph "Memset
            # (Unknown)", the same memset launched eagerly "Memset (Device)"
            out = {}
            for k, n in p["by_name"].items():
                k = "Memset" if k.startswith("Memset (") else k
                out[k] = out.get(k, 0) + n
            return out
        ran, want = names(prof), names(eager)
        diff = {k: (ran.get(k, 0), want.get(k, 0)) for k in {*ran, *want}
                if ran.get(k, 0) != want.get(k, 0)}
        require(not diff, f"graphs, {label}: the replayed request's kernels "
                f"differ from the eager request's (replayed, eager): {diff}")
        out.update({
            "kernels": prof["kernels"], "eager_kernels": eager["kernels"],
            "device_busy_us": prof["device_busy_us"],
            "eager_device_busy_us": eager["device_busy_us"],
            "idle_share": 1 - prof["device_busy_us"] / prof["wall_us"],
            "eager_idle_share": 1 - eager["device_busy_us"]
            / eager["wall_us"]})
    log(f"graphs, {label}: request wall {out['request_wall_ms']:.3f} ms "
        f"(median); phases a request, ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    sorted(out["phase_ms_per_request"].items()))
        + f"; {out['sentences_per_s']:.1f} sentences/s; profiled: "
        + ("device time not measured" if "kernels" not in out else
           f"{out['kernels']} kernels, device busy "
           f"{out['device_busy_us']:.1f} us, idle "
           f"{100 * out['idle_share']:.1f}% (eager, same request: "
           f"{out['eager_kernels']} kernels, "
           f"{out['eager_device_busy_us']:.1f} us, idle "
           f"{100 * out['eager_idle_share']:.1f}%)") + f" ({gpu_line()})")
    log(f"graphs, {label}: the profiled request {AB_ROUNDS} times in turns, "
        "replayed / eager: wall "
        f"{out['same_request_ms']['replayed']:.3f} / "
        f"{out['same_request_ms']['eager']:.3f} ms (median); phases ms: "
        + ", ".join(f"{k} {phases['replayed'][k]:.3f} / "
                    f"{phases['eager'].get(k, 0.0):.3f}"
                    for k in sorted(phases["replayed"]))
        + f" ({gpu_line()})")
    return out


# each counter's kernels in a profile: a name holds all of a tuple's parts
PROFILE_NAMES = {
    "q4_matmul": (("q4_matmul_kernel",),),
    "fused_layer_norm": (("ln_rows_kernel", ", false>("),
                         ("ln_block_kernel", ", false>(")),
    "fused_layer_norm_codes": (("ln_rows_kernel", ", true>("),
                               ("ln_block_kernel", ", true>(")),
    "fused_qkv_attention": (("fused_attention_",),),
    "multi_head_attention": (("mha_", "_kernel<"),),
    # forms (a) and (b), and form (c) (int8_matmul_gelu), are one kernel
    "int8_matmul": (("int8_matmul_kernel",),),
    "quantize_activations_i8": (("quantize_rows_kernel",),
                                ("quantize_wide_kernel",)),
}


def kernels_agree_with_counters(model, label: str, request, prof) -> None:
    """The profiled request's launches of each kernel (the programs
    replayed) against the launch counters of the same request run once
    more: a replay adds what its capture counted, so the two agree."""
    from bert_tpu_torch._graphs import COUNTERS

    before = {c.__name__: c.launches for c in COUNTERS}
    model.encode_batch(request)
    counted = {c.__name__: c.launches - before[c.__name__]
               for c in COUNTERS}
    counted["int8_matmul"] += counted.pop("int8_matmul_gelu")
    seen = {name: sum(n for k, n in prof["by_name"].items()
                      if any(all(p in k for p in parts) for parts in alts))
            for name, alts in PROFILE_NAMES.items()}
    log(f"graphs, {label}: one request's launches by the counters "
        f"{counted}, in the profile {seen}")
    require(seen == counted, f"graphs, {label}: the profile's launches "
            f"{seen} are not the counters' {counted}")


def main_path(dev, rng, counters):
    import numpy as np
    import torch

    from bert_tpu_torch import BertTorch
    from bert_tpu_torch.formats import GgmlHParams, write_ggml
    from bert_tpu_torch.params import BertConfig, random_named_tensors

    cfg = BertConfig(**MINILM_L6)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "minilm_l6_q4_0.bin")
    t0 = time.perf_counter()
    hp = GgmlHParams(cfg.n_vocab, cfg.n_max_tokens, cfg.n_embd,
                     cfg.n_intermediate, cfg.n_head, cfg.n_layer, ftype=2)
    write_ggml(path, hp, fixture_tokens(cfg.n_vocab),
               random_named_tensors(cfg, 0))
    log(f"wrote MiniLM-L6 q4_0 ggml file from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({os.path.getsize(path) / 1e6:.1f} MB)")

    t0 = time.perf_counter()
    model = BertTorch.from_file(path)  # the card, bf16 compute, f16 wire
    log(f"BertTorch.from_file -> {model.device}, {model.compute_dtype}, "
        f"wire {model.wire_dtype} in {time.perf_counter() - t0:.2f} s; "
        f"load phases {model.stats()['load_phases']}")
    require(model.device.type == "cuda", "from_file did not default to cuda")
    requests = [request_corpus(rng) for _ in range(20)]
    lengths = [len(t) for t in model.tokenizer.tokenize_batch(
        requests[0], cfg.n_max_tokens)]
    log(f"request: {len(requests[0])} sentences, tokens min/max "
        f"{min(lengths)}/{max(lengths)}, "
        f"{sum(n > 64 for n in lengths)} over 64")
    require(max(lengths) == 512 and sum(n > 64 for n in lengths) >= 2
            and sum(n <= 64 for n in lengths) >= 2,
            "request corpus does not take both routes and the 512 bucket")

    # the warm pass: the first call loads the kernels, and each shape's
    # first batch captures its program
    t0 = time.perf_counter()
    first = model.encode_batch(requests[0])
    for r in requests[1:]:
        model.encode_batch(r)
    torch.cuda.synchronize()
    log(f"main path: warm pass over the {len(requests)} requests (every "
        f"shape's capture) in {time.perf_counter() - t0:.3f} s, "
        f"{n_programs(model)} programs ({gpu_line()})")

    batches0 = dict(model.timers.bucket_counts)
    timed = timed_start(model)
    for c in counters:
        c.launches = 0
    outs, lat = [], []
    for r in requests:
        t0 = time.perf_counter()
        outs.append(model.encode_batch(r))  # returns after the host copy
        lat.append(time.perf_counter() - t0)
    launches = {c.__name__: c.launches for c in counters}
    timed_end(model, timed, lat, sum(len(r) for r in requests))
    # d_head 32 takes the fused kernel: the per-(b, h) one must stay idle
    require(launches.pop("multi_head_attention") == 0,
            "multi_head_attention launched on the MiniLM main path")
    dt = sum(lat)
    n_sent = sum(len(r) for r in requests)
    log(f"main path: {len(requests)} encode_batch requests, {n_sent} "
        f"sentences in {dt:.4f} s = {n_sent / dt:.1f} sentences/s; "
        f"request latency median {statistics.median(lat) * 1e3:.3f} ms, "
        f"max {max(lat) * 1e3:.3f} ms (warm; {gpu_line()})")
    log(f"main path buckets: {model.stats()['buckets']}")
    log(f"main path kernel launches: {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was never launched on the main path")
    # 2L + 1 LayerNorms a batch: the embedding's and two a layer
    batches = sum(n - batches0.get(k, 0)
                  for k, n in model.timers.bucket_counts.items())
    require(launches["fused_layer_norm"] == (2 * cfg.n_layer + 1) * batches,
            f"fused_layer_norm launched {launches['fused_layer_norm']} times "
            f"in {batches} batches, not {2 * cfg.n_layer + 1} a batch")
    before = dict(model.timers.bucket_counts)
    prof = profile_request(model, requests[0], "main path")
    one = {k: n - before.get(k, 0) for k, n in
           model.timers.bucket_counts.items() if n > before.get(k, 0)}
    split = main_split(one, model, rng)
    roofline_request(cfg, one, statistics.median(lat), prof)
    graphs = {"main path": graphs_phase(model, "main path", requests[0],
                                        prof, timed),
              "warmup": warmup_cost(path)}

    for req, emb in zip(requests + [requests[0]], outs + [first]):
        require(emb.shape == (len(req), cfg.n_embd), f"bad shape {emb.shape}")
        require(bool(np.isfinite(emb).all()), "non-finite embeddings")
        norms = np.linalg.norm(emb, axis=-1)
        require(bool(np.all(np.abs(norms - 1.0) < 1e-2)),
                f"norms off 1: {norms.min():.4f}..{norms.max():.4f}")
    require(np.array_equal(outs[0], first),
            "the same request embedded twice gave different results")

    # against the plain path on the CPU (f32)
    t0 = time.perf_counter()
    cpu = BertTorch.from_file(path, device="cpu")
    ref = cpu.encode_batch(requests[0])
    log(f"CPU f32 reference in {time.perf_counter() - t0:.2f} s")
    gpu32 = BertTorch.from_file(path, device="cuda",
                                compute_dtype=torch.float32)
    gpu32.encode_batch(requests[0])  # its first request
    f32 = f32_request(gpu32, requests[0], counters)
    e32 = gpu32.encode_batch(requests[0])
    cos32 = np.sum(e32 * ref, axis=-1)
    err32 = float(np.abs(e32 - ref).max())
    log(f"card f32 vs CPU f32: min cos {cos32.min():.7f}, max|Δ| {err32:.3e}")
    require(bool(np.all(cos32 > 0.9999)), "card f32 cos <= 0.9999")
    require(err32 <= 5e-3, "card f32 max|Δ| > 5e-3")
    cos16 = np.sum(first * ref, axis=-1)
    log(f"card bf16 (f16 wire) vs CPU f32: min cos {cos16.min():.6f}, "
        f"max|Δ| {float(np.abs(first - ref).max()):.3e}")
    require(bool(np.all(cos16 > 0.999)), "card bf16 cos <= 0.999")
    main = {"path": path, "model": model, "requests": requests,
            "outs": outs, "f32_request": f32, "graphs": graphs}
    return launches, n_sent / dt, split, prof, main


def warmup_cost(path: str) -> dict:
    """``warmup()`` of a fresh engine on the main path's file, as a server
    runs it before its first request (the default grid: every bucket at
    1, 8 and max_batch rows, every packed row bucket): its seconds, the
    programs it captured and the memory it took (:func:`timed_warmup`)."""
    from bert_tpu_torch import BertTorch

    model = BertTorch.from_file(path)
    out = timed_warmup(model, model.warmup)
    log(f"main path: warmup() of a fresh engine (the default grid) in "
        f"{out['seconds']:.3f} s, {out['programs']} programs captured; "
        + warmup_memory(out) + f" ({gpu_line()})")
    return out


def timed_warmup(model, warmup) -> dict:
    """``warmup()``'s seconds and programs, and the memory it took: the
    peak allocated above what was allocated before it, and what stays
    allocated (the programs' static buffers) and reserved (the caching
    allocator's segments, the programs' pool among them) after it."""
    import torch

    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warmup()
    torch.cuda.synchronize()
    mib = 2 ** 20
    return {"seconds": time.perf_counter() - t0,
            "programs": n_programs(model),
            "allocated_before_mib": allocated / mib,
            "peak_above_mib":
                (torch.cuda.max_memory_allocated() - allocated) / mib,
            "allocated_after_mib":
                (torch.cuda.memory_allocated() - allocated) / mib,
            "reserved_after_mib":
                (torch.cuda.memory_reserved() - reserved) / mib}


def warmup_memory(w: dict) -> str:
    return (f"peak allocated {w['peak_above_mib']:.1f} MiB above the "
            f"{w['allocated_before_mib']:.1f} MiB allocated before it; after "
            f"it {w['allocated_after_mib']:.1f} MiB more allocated, "
            f"{w['reserved_after_mib']:.1f} MiB more reserved")


def f32_request(model, request, counters) -> dict:
    """One request on the card in f32 (the agreement gate's engine, and
    what a user who wants exact embeddings gets), with every launch count
    set to 0 just before and read just after: the f32 q4_matmul and fused
    attention instances must both launch (d_head 32, and every M of the
    request is under FUSED_MAX_M_F32), the per-(batch, head) attention not.
    Then one more request profiled: device busy, kernels, and the two f32
    kernels' shares of the device time."""
    import torch

    timed = timed_start(model)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    model.encode_batch(request)
    timed_end(model, timed, [time.perf_counter() - t0], len(request))
    launches = {c.__name__: c.launches for c in counters}
    log(f"main path f32: one request, kernel launches {launches}")
    require(launches["q4_matmul"] > 0
            and launches["fused_qkv_attention"] > 0,
            "the f32 main path did not launch the f32 q4_matmul and fused "
            "attention kernels")
    require(launches["multi_head_attention"] == 0,
            "multi_head_attention launched on the f32 main path")
    prof = profile_request(model, request, "main path f32", extra=(
        ("q4_matmul_f32", (("q4_matmul", "(float const*"),)),
        ("fused_attention_f32", ("fused_attention_f32_kernel",))))
    if prof is not None:
        busy = prof["device_busy_us"]
        log(f"main path f32: q4_matmul {prof['q4_matmul_f32_us']:.1f} us "
            f"({100 * prof['q4_matmul_f32_us'] / busy:.1f}%), fused "
            f"attention {prof['fused_attention_f32_us']:.1f} us "
            f"({100 * prof['fused_attention_f32_us'] / busy:.1f}%) of "
            f"{busy:.1f} us device busy ({gpu_line()})")
        require(prof["q4_matmul_f32_launches"] == launches["q4_matmul"]
                and prof["fused_attention_f32_launches"]
                == launches["fused_qkv_attention"],
                "the f32 request's profile does not show the counted "
                "launches of the f32 kernels")
    return {"launches": launches, "profile": prof,
            "graphs": graphs_phase(model, "main path f32", request, prof,
                                   timed)}


def api_phase(main: dict, rate: float, prof, counters) -> dict:
    """The main path's API switches (bert_tpu's calls the port takes):
    (a) the same MiniLM file with ``use_kernels=False`` answers the main
    path's requests with every counted kernel idle and agrees with the
    default engine, whose counts it leaves as they were; (b) the native
    tokenizer's wall time by thread count; (c) ``read_ggml(mmap=False)``
    equals the mmap reader on the file."""
    import numpy as np
    import torch

    from bert_tpu_torch import BertTorch

    model, requests, outs = main["model"], main["requests"], main["outs"]

    def one_request_counts():
        for c in counters:
            c.launches = 0
        model.encode_batch(requests[0])
        torch.cuda.synchronize()
        return {c.__name__: c.launches for c in counters}

    # (a) the engine's kernel switch
    default_counts = one_request_counts()
    plain = BertTorch.from_file(main["path"], use_kernels=False)
    require(plain.device.type == "cuda" and plain.use_kernels is False,
            "use_kernels=False did not build a card engine")
    for r in requests:  # the warm pass: cuBLAS, every shape's capture
        plain.encode_batch(r)
    torch.cuda.synchronize()
    timed = timed_start(plain)
    for c in counters:
        c.launches = 0
    got, lat = [], []
    for r in requests:
        t0 = time.perf_counter()
        got.append(plain.encode_batch(r))
        lat.append(time.perf_counter() - t0)
    launches = {c.__name__: c.launches for c in counters}
    timed_end(plain, timed, lat, sum(len(r) for r in requests))
    log(f"use_kernels=False: {len(requests)} requests, kernel launches "
        f"{launches}")
    require(all(n == 0 for n in launches.values()),
            f"a kernel launched under use_kernels=False: {launches}")
    cos = np.concatenate([np.sum(a * b, axis=-1) for a, b in zip(got, outs)])
    n_sent = sum(len(r) for r in requests)
    log(f"use_kernels=False vs the default engine, bf16: min cos "
        f"{cos.min():.6f} over {cos.size} sentences; {n_sent / sum(lat):.1f} "
        f"sentences/s (default {rate:.1f}; {gpu_line()})")
    require(cos.size == n_sent and bool(np.all(cos > 0.999)),
            "use_kernels=False disagrees with the default engine (cos <= "
            "0.999)")
    plain_prof = profile_request(plain, requests[0], "use_kernels=False")
    busy = [None if p is None else p["device_busy_us"]
            for p in (prof, plain_prof)]
    log(f"device busy a request: default {busy[0]} us, use_kernels=False "
        f"{busy[1]} us")
    again = one_request_counts()
    log(f"default engine, one request: kernel launches {default_counts} "
        f"before the plain engine, {again} after")
    require(again == default_counts and all(
        default_counts[k] > 0 for k in ("q4_matmul", "fused_layer_norm",
                                        "fused_qkv_attention")),
            "the default engine's kernel counts moved")
    out = {"use_kernels_false": {
        "launches": launches, "min_cos": float(cos.min()),
        "sentences_per_s": n_sent / sum(lat),
        "device_busy_us": busy[1], "default_device_busy_us": busy[0],
        "default_request_launches": default_counts,
        "graphs": graphs_phase(plain, "use_kernels=False", requests[0],
                               plain_prof, timed)}}
    out["tokenize"] = tokenize_timing(model, requests[0])
    out["read_ggml"] = read_ggml_modes(main["path"])
    return out


def tokenize_timing(model, request, reps: int = 7) -> dict:
    """(b) ``NativeWordPiece.tokenize_batch`` wall time (median of
    ``reps``) at 1, 2, 4 and 8 threads and the auto default, on one
    main-path request and on 50 requests of request_corpus (2,750
    sentences, the size of bench.py's 2,758-sentence corpus), with
    ``BERT_TPU_TOKENIZE_THREADS`` unset. The ids must not move."""
    import numpy as np

    native = model.tokenizer._native
    require(native is not None, "the native tokenizer did not load")
    rng = np.random.default_rng(22)
    corpus = [s for _ in range(50) for s in request_corpus(rng)]
    n_max = model.config.n_max_tokens
    env = os.environ.pop("BERT_TPU_TOKENIZE_THREADS", None)
    rows = {}
    try:
        for label, texts in (("request", request), ("corpus", corpus)):
            want = native.tokenize_batch(texts, n_max, n_threads=1)
            row = {}
            for n_threads in (1, 2, 4, 8, None):
                require(native.tokenize_batch(texts, n_max, n_threads)
                        == want, f"tokenize_batch ids moved at n_threads="
                        f"{n_threads}")
                wall = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    native.tokenize_batch(texts, n_max, n_threads)
                    wall.append(time.perf_counter() - t0)
                key = (f"auto ({native._thread_count(len(texts), None)})"
                       if n_threads is None else str(n_threads))
                row[key] = statistics.median(wall) * 1e3
            rows[f"{label} ({len(texts)} sentences)"] = row
    finally:
        if env is not None:
            os.environ["BERT_TPU_TOKENIZE_THREADS"] = env
    log(f"tokenize_batch wall ms by n_threads (median of {reps}; "
        f"os.cpu_count() {os.cpu_count()}; {gpu_line()}): "
        + "; ".join(f"{label}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in row.items())
            for label, row in rows.items()))
    return {"cpu_count": os.cpu_count(), "ms": rows}


def read_ggml_modes(path: str) -> dict:
    """(c) ``read_ggml(path, mmap=False)`` against the mmap reader on the
    main path's file: every record the same, each parse timed."""
    import numpy as np

    from bert_tpu_torch.formats import read_ggml

    t0 = time.perf_counter()
    a = read_ggml(path)
    mmap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = read_ggml(path, mmap=False)
    stream_s = time.perf_counter() - t0
    require(a.hparams == b.hparams and a.vocab_tokens == b.vocab_tokens
            and list(a.tensors) == list(b.tensors),
            "read_ggml(mmap=False): header, vocab or names differ")
    for name, ra in a.tensors.items():
        rb = b.tensors[name]
        require((ra.shape, ra.ftype) == (rb.shape, rb.ftype)
                and not isinstance(rb.data if rb.qraw is None else rb.qraw,
                                   np.memmap),
                f"read_ggml(mmap=False): {name} differs")
        if ra.qraw is None:
            require(np.array_equal(ra.data, rb.data),
                    f"read_ggml(mmap=False): {name}'s data differ")
        else:
            require(np.array_equal(ra.qraw, rb.qraw)
                    and np.array_equal(ra.to_f32(), rb.to_f32()),
                    f"read_ggml(mmap=False): {name}'s q4 blocks differ")
    log(f"read_ggml of the MiniLM file ({len(a.tensors)} tensors, "
        f"{os.path.getsize(path) / 1e6:.1f} MB): mmap {mmap_s * 1e3:.2f} ms "
        f"(pages fault in at first use), stream {stream_s * 1e3:.2f} ms; "
        f"records equal")
    return {"mmap_ms": mmap_s * 1e3, "stream_ms": stream_s * 1e3}


def roofline_request(cfg, buckets, latency_s: float, prof) -> None:
    """The request's speed of light by ``bert_tpu_torch.profiling.roofline``
    (the H100's bf16 and HBM peaks), summed over the (rows, T) batches it
    ran (each reads the weights once), and its utilization of the median
    request latency and of the profiled device time."""
    from bert_tpu_torch.profiling import roofline

    ests = [(n, roofline(cfg, rows, seq)) for (rows, seq, _), n in
            buckets.items()]
    sol_s = sum(n * e.sol_s for n, e in ests)
    # the request as one estimate: its batches' speed of light summed
    util = sol_s / latency_s
    busy = ("device time not measured" if prof is None else
            f"{100 * sol_s / (prof['device_busy_us'] * 1e-6):.2f}% of its "
            f"{prof['device_busy_us']:.1f} us of device time")
    log(f"main path roofline (profiling.roofline: 989 TFLOP/s bf16, 3.35 "
        f"TB/s): {sol_s * 1e6:.2f} us for the request's batches "
        f"{sorted(buckets)}; utilization {100 * util:.2f}% of the median "
        f"request latency {latency_s * 1e3:.3f} ms, {busy} ({gpu_line()})")


def main_split(buckets, model, rng):
    """q4_matmul's and the fused attention's device time in one main-path
    request, bucket by bucket: each (rows, T) batch the request ran, timed
    alone by CUDA-graph replay on random bf16 activations — the four
    matmuls of a layer on layer 0's own Q4 weights, and the attention with
    packed rows' block-diagonal bias (four 16-token segments) or a
    key-side bias — times its batches and the layer count."""
    import numpy as np
    import torch

    from bert_tpu_torch.ops.fused_attention import fused_qkv_attention
    from bert_tpu_torch.ops.q4_matmul import q4_matmul

    cfg = model.config
    layer = model.model.layers[0]
    weights = [layer.w(k) for k in ("qkv_w", "o_w", "ff_i_w", "ff_o_w")]
    h, dh = cfg.n_head, cfg.d_head

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda().to(torch.bfloat16)

    split = []
    for (rows, t, kind), n in sorted(buckets.items()):
        q4_ms = 0.0
        for w in weights:
            x = rand(rows * t, w.packed.shape[0] * 2)
            q4_ms += time_ms(lambda: q4_matmul(x, w))
        qkv = rand(rows, t, 3 * h * dh)
        if kind == "packed":
            seg = np.arange(t) // 16
            bias = np.where(seg[:, None] == seg[None, :], 0.0, -1e9)
            bias = np.ascontiguousarray(np.broadcast_to(bias, (rows, t, t)))
        else:
            bias = np.zeros((rows, t))
        bias = torch.from_numpy(bias.astype(np.float32)).cuda()
        attn_ms = time_ms(lambda: fused_qkv_attention(
            qkv, bias, n_head=h, d_head=dh, scale=dh ** -0.5))
        per = n * cfg.n_layer
        split.append({"bucket": f"{rows}x{t}" + (" packed" if kind else ""),
                      "batches": n, "q4_matmul_ms_per_layer": q4_ms,
                      "fused_attention_ms_per_call": attn_ms,
                      "q4_matmul_ms_per_request": q4_ms * per,
                      "fused_attention_ms_per_request": attn_ms * per})
    q4_total = sum(r["q4_matmul_ms_per_request"] for r in split)
    attn_total = sum(r["fused_attention_ms_per_request"] for r in split)
    log(f"main path: one request by bucket (graph replay, {gpu_line()}): "
        f"q4_matmul {q4_total:.4f} ms, fused attention {attn_total:.4f} ms")
    for r in split:
        log(f"  {r['bucket']:>14s}: {r['batches']} batch x {cfg.n_layer} "
            f"layers: q4_matmul 4 x {r['q4_matmul_ms_per_layer'] / 4:.5f} "
            f"= {r['q4_matmul_ms_per_request']:.4f} ms "
            f"({100 * r['q4_matmul_ms_per_request'] / q4_total:.1f}%), "
            f"attention {r['fused_attention_ms_per_call']:.5f} = "
            f"{r['fused_attention_ms_per_request']:.4f} ms "
            f"({100 * r['fused_attention_ms_per_request'] / attn_total:.1f}%)")
    return split


# ---------------------------------------------------------------------------
# hf_server path
# ---------------------------------------------------------------------------

def write_hf_dir(path: str, seed: int = 0) -> None:
    """A random-weight HF checkpoint directory at rubert-tiny2's published
    widths: config.json, pytorch_model.bin (seeded), vocab.txt (the fixture
    vocab padded to 83,828 entries) and 1_Pooling/config.json declaring CLS
    pooling, as the model card's example takes the [CLS] vector."""
    import numpy as np
    import torch

    from bert_tpu_torch.params import BertConfig, random_named_tensors

    c = RUBERT_TINY2
    cfg = BertConfig(n_vocab=c["vocab_size"],
                     n_max_tokens=c["max_position_embeddings"],
                     n_embd=c["hidden_size"],
                     n_intermediate=c["intermediate_size"],
                     n_head=c["num_attention_heads"],
                     n_layer=c["num_hidden_layers"])
    os.makedirs(os.path.join(path, "1_Pooling"), exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(c, f, indent=1)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                random_named_tensors(cfg, seed).items()},
               os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(fixture_tokens(cfg.n_vocab)) + "\n")
    with open(os.path.join(path, "1_Pooling", "config.json"), "w") as f:
        json.dump({"word_embedding_dimension": cfg.n_embd,
                   "pooling_mode_cls_token": True,
                   "pooling_mode_mean_tokens": False}, f)


def hf_request(rng):
    """One mixed request: 40 short sentences (packed rows), 8 of 70-400
    tokens (buckets of 128-512) and one of 2,100 words, truncated into the
    2,048 bucket."""
    words = sorted(_WORDS)

    def sentence(n):
        return " ".join(rng.choice(words, size=n)) + "."

    return ([sentence(int(n)) for n in rng.integers(4, 40, size=40)]
            + [sentence(int(n)) for n in rng.integers(70, 400, size=8)]
            + [sentence(2100)])


class WireClient:
    """A blocking client of the reference wire and its framed messages,
    written from the protocol (bert_tpu_torch/server.py), not with it."""

    EVAL, BATCH = b"\xb5\x87\xe3\x01", b"\xb5\x87\xe3\x02"
    META, STATS2 = b"\xb5\x87\xe3\x03", b"\xb5\x87\xe3\x05"

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port), 60)
        (self.n_embd,) = struct.unpack("<i", self.recv(4))

    def recv(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            more = self.sock.recv(n - len(buf))
            if not more:
                raise ConnectionError("server closed the connection")
            buf += more
        return buf

    def rows(self, n: int):
        import numpy as np

        return np.frombuffer(self.recv(4 * n * self.n_embd),
                             "<f4").reshape(n, self.n_embd)

    def text(self, t: str):
        self.sock.sendall(t.encode("utf-8"))
        return self.rows(1)[0]

    def eval(self, ids):
        self.sock.sendall(self.EVAL + struct.pack("<i", len(ids))
                          + struct.pack(f"<{len(ids)}i", *ids))
        return self.rows(1)[0]

    def batch(self, token_lists):
        body = b"".join(struct.pack(f"<i{len(t)}i", len(t), *t)
                        for t in token_lists)
        self.sock.sendall(self.BATCH + struct.pack("<i", len(token_lists))
                          + body)
        return self.rows(len(token_lists))

    def framed(self, magic: bytes, n: int) -> bytes:
        self.sock.sendall(magic)
        reply = self.recv(4 + n)
        require(reply[:4] == magic, f"bad reply magic {reply[:4]!r}")
        return reply[4:]

    def close(self):
        self.sock.close()


def hf_server_path(rng, counters):
    import numpy as np
    import torch

    from bert_tpu_torch import BertTorch
    from bert_tpu_torch.server import ServerThread

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke", "rubert_tiny2_seed0")
    t0 = time.perf_counter()
    write_hf_dir(work)
    log(f"hf_server: wrote a rubert-tiny2-width HF directory from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    model = BertTorch.from_file(work)  # the card, bf16 compute, f16 wire
    log(f"hf_server: BertTorch.from_file -> {model.device}, "
        f"{model.compute_dtype}, d_head {model.config.d_head}, pooling "
        f"{model.pooling} in {time.perf_counter() - t0:.2f} s; load phases "
        f"{model.stats()['load_phases']}")
    require(model.device.type == "cuda" and model.config.d_head == 26
            and model.pooling == "cls" and model.n_max_tokens == 2048,
            "hf_server: the directory did not load as rubert-tiny2")
    max_batch = 64
    warm = timed_warmup(model, lambda: model.warmup(
        batch_sizes=[1, 8, max_batch], max_rows=max_batch))
    log(f"hf_server: warmup (every bucket at 1/8/{max_batch} rows, every "
        f"packed row bucket) in {warm['seconds']:.3f} s, {warm['programs']} "
        f"programs captured; " + warmup_memory(warm) + f" ({gpu_line()})")

    texts = hf_request(rng)
    toks = model.tokenizer.tokenize_batch(texts, model.n_max_tokens)
    lengths = [len(t) for t in toks]
    require(max(lengths) == 2048 and sum(n > 64 for n in lengths) >= 8
            and sum(n <= 64 for n in lengths) >= 2,
            "hf_server request does not take both routes and the 2048 "
            "bucket")
    log(f"hf_server request: {len(toks)} sentences, tokens min/max "
        f"{min(lengths)}/{max(lengths)}, {sum(n > 64 for n in lengths)} "
        "over 64")
    words = sorted(_WORDS)
    client_texts = [[" ".join(rng.choice(words, size=int(n))) for n in
                     rng.integers(3, 150, size=6)] for _ in range(8)]
    n_frames = 10
    replies = {}

    with ServerThread(model, max_batch=max_batch) as st:
        for c in counters:
            c.launches = 0

        def text_client(batch):
            cl = WireClient(st.port)
            try:
                return [cl.text(t) for t in batch]
            finally:
                cl.close()

        with ThreadPoolExecutor(len(client_texts)) as pool:
            replies["text"] = list(pool.map(text_client, client_texts))
        cl = WireClient(st.port)
        replies["eval"] = cl.eval(toks[42])
        cl.batch(toks)  # the warm frame: shapes the grid does not hold
        timed = timed_start(model)
        lat = []
        for _ in range(n_frames):
            t0 = time.perf_counter()
            replies["batch"] = cl.batch(toks)
            lat.append(time.perf_counter() - t0)
        timed_end(model, timed, lat, n_frames * len(toks))
        version, n_embd, n_max = struct.unpack(
            "<iii", cl.framed(cl.META, 12))
        served, batches, n_lat, p50, p95, p99 = struct.unpack(
            "<QQIIII", cl.framed(cl.STATS2, 32))
        cl.close()
        launches = {c.__name__: c.launches for c in counters}
    rate = n_frames * len(toks) / sum(lat)
    log(f"hf_server: {n_frames} BATCH frames of {len(toks)} sentences in "
        f"{sum(lat):.4f} s = {rate:.1f} sentences/s (warm; frame latency "
        f"median {statistics.median(lat) * 1e3:.3f} ms, max "
        f"{max(lat) * 1e3:.3f} ms; {gpu_line()})")
    log(f"hf_server: META version {version} n_embd {n_embd} n_max_tokens "
        f"{n_max}; STATS2 served {served} in {batches} batches, request "
        f"latency p50 {p50} us p95 {p95} us p99 {p99} us over {n_lat}")
    log(f"hf_server buckets: {model.stats()['buckets']}")
    log(f"hf_server kernel launches: {launches}")
    require((n_embd, n_max) == (312, 2048), "hf_server: META reply wrong")
    require(served == sum(map(len, client_texts)) + 1
            + (1 + n_frames) * len(toks), f"hf_server: STATS2 served {served}")
    require(launches["multi_head_attention"] > 0
            and launches["fused_layer_norm"] > 0,
            "hf_server: the per-(b, h) attention or LayerNorm kernel was "
            "never launched")
    require(launches["fused_qkv_attention"] == 0
            and launches["q4_matmul"] == 0,
            "hf_server: a d_head 26 dense model launched the fused "
            "attention or Q4 kernel")
    before = dict(model.timers.bucket_counts)
    prof = profile_request(model, texts, "hf_server")
    one = {k: n - before.get(k, 0) for k, n in
           model.timers.bucket_counts.items() if n > before.get(k, 0)}
    split = attention_split(one, model.config, rng)
    graphs = {"hf_server warmup": warm,
              "hf_server": graphs_phase(model, "hf_server", texts, prof,
                                        timed, exact=False)}

    # every reply against the plain path on the CPU (f32), same directory
    t0 = time.perf_counter()
    cpu = BertTorch.from_file(work, device="cpu")
    flat_texts = [t for batch in client_texts for t in batch]
    ref_text = cpu.encode_batch(flat_texts)
    ref_batch = cpu.eval_tokens(toks)
    log(f"hf_server: CPU f32 reference in {time.perf_counter() - t0:.2f} s")
    got_text = np.stack([e for r in replies["text"] for e in r])
    cos = np.concatenate([np.sum(got_text * ref_text, axis=-1),
                          np.sum(replies["batch"] * ref_batch, axis=-1),
                          [float(replies["eval"] @ ref_batch[42])]])
    log(f"hf_server: every reply (card bf16, f16 wire) vs CPU f32: "
        f"{len(cos)} replies, min cos {cos.min():.6f}, max|Δ| "
        f"{float(np.abs(replies['batch'] - ref_batch).max()):.3e} (BATCH)")
    require(bool(np.all(cos > 0.999)), "hf_server: a reply's cos <= 0.999")
    gpu32 = BertTorch.from_file(work, device="cuda",
                                compute_dtype=torch.float32)
    gpu32.eval_tokens(toks)  # its first request: every shape's capture
    timed = timed_start(gpu32)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    e32 = gpu32.eval_tokens(toks)
    timed_end(gpu32, timed, [time.perf_counter() - t0], len(toks))
    launches32 = {c.__name__: c.launches for c in counters}
    log(f"hf_server f32: one request, kernel launches {launches32}")
    require(launches32["multi_head_attention"] > 0,
            "hf_server: the f32 request did not launch the per-(batch, "
            "head) attention")
    cos32 = np.sum(e32 * ref_batch, axis=-1)
    err32 = float(np.abs(e32 - ref_batch).max())
    log(f"hf_server: card f32 vs CPU f32: min cos {cos32.min():.7f}, "
        f"max|Δ| {err32:.3e}")
    require(bool(np.all(cos32 > 0.9999)), "hf_server: card f32 cos <= 0.9999")
    require(err32 <= 5e-3, "hf_server: card f32 max|Δ| > 5e-3")
    prof32 = hf_f32_profile(gpu32, texts, launches32)
    graphs["hf_server f32"] = graphs_phase(gpu32, "hf_server f32", texts,
                                           prof32, timed)
    return launches, rate, split, prof, {"launches": launches32,
                                         "cos_min": float(cos32.min()),
                                         "max_abs_err": err32,
                                         "profile": prof32}, graphs


def hf_f32_profile(model, texts, counted) -> dict:
    """hf_server's f32 engine (what a user who wants exact f32 embeddings
    of long Russian documents gets) on the same request, profiled as the
    main path's f32 request is: device busy, idle share, kernels, and the
    per-(batch, head) attention's f32 kernel's share of the device time;
    its launches must be the counted request's."""
    import torch

    from bert_tpu_torch.ops.attention import multi_head_attention

    torch.cuda.synchronize()
    before = multi_head_attention.launches
    prof = profile_request(model, texts, "hf_server f32", extra=(
        ("mha_f32", ("mha_f32_kernel",)),))
    require(multi_head_attention.launches - before
            == counted["multi_head_attention"],
            "hf_server f32: the profiled request did not launch the "
            "per-(batch, head) attention as the counted one did")
    if prof is not None:
        busy = prof["device_busy_us"]
        log(f"hf_server f32: per-(b, h) attention {prof['mha_f32_us']:.1f} "
            f"us ({100 * prof['mha_f32_us'] / busy:.1f}%) / "
            f"{prof['mha_f32_launches']} launches of {busy:.1f} us device "
            f"busy ({gpu_line()})")
        require(prof["mha_f32_launches"] == counted["multi_head_attention"],
                "hf_server f32: the profile does not show the counted "
                "launches of the f32 per-(batch, head) attention")
    return prof


def attention_split(buckets, cfg, rng):
    """The per-(b, h) attention's device time in one request, bucket by
    bucket: each (rows, T) batch the request ran, timed alone by CUDA-graph
    replay on random bf16 operands (packed rows with a block-diagonal bias
    of four 16-token segments), times its batches and the layer count."""
    import numpy as np
    import torch

    from bert_tpu_torch.ops.attention import multi_head_attention

    h, dh = cfg.n_head, cfg.d_head
    split = []
    for (rows, t, kind), n in sorted(buckets.items()):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (rows, h, t, dh)).astype(np.float32)).cuda().to(torch.bfloat16)
            for _ in range(3))
        if kind == "packed":
            seg = np.arange(t) // 16
            bias = np.where(seg[:, None] == seg[None, :], 0.0, -1e9)
            bias = np.ascontiguousarray(np.broadcast_to(bias, (rows, t, t)))
        else:
            bias = np.zeros((rows, t))
        bias = torch.from_numpy(bias.astype(np.float32)).cuda()
        ms = time_ms(lambda: multi_head_attention(q, k, v, bias,
                                                  scale=dh ** -0.5))
        split.append({"bucket": f"{rows}x{t}" + (" packed" if kind else ""),
                      "batches": n, "ms_per_call": ms,
                      "ms_per_request": ms * n * cfg.n_layer})
    total = sum(r["ms_per_request"] for r in split)
    log(f"hf_server: per-(b, h) attention in one request, by bucket "
        f"(graph replay, {gpu_line()}): {total:.4f} ms")
    for r in split:
        log(f"  {r['bucket']:>14s}: {r['batches']} batch x {cfg.n_layer} "
            f"layers x {r['ms_per_call']:.5f} ms = {r['ms_per_request']:.4f}"
            f" ms ({100 * r['ms_per_request'] / total:.1f}%)")
    return split


# ---------------------------------------------------------------------------
# int8 path
# ---------------------------------------------------------------------------

def int8_activations(rng, m: int, k: int):
    """x [m, k] f32: rows at spread scales; row 0 all zeros; where m > 2,
    row 1 holds ±127 (sx = 1, so x·inv = x) and ties k + 0.5 (±0.5, 2.5,
    -3.5, ±126.5), row 2 ties at sx = 1/8 (x·inv = 0.5, -1.5, 12.5)."""
    import numpy as np

    x = (rng.standard_normal((m, k))
         * rng.uniform(0.01, 8.0, (m, 1))).astype(np.float32)
    x[0] = 0.0
    if m > 2 and k >= 2:
        x[1] = rng.choice([0.5, -0.5, 2.5, -3.5, 126.5, -126.5], size=k)
        x[1, :2] = (127.0, -127.0)
        x[2] = rng.choice([0.0625, -0.1875, 1.5625], size=k)
        x[2, 0] = 127.0 / 8
    return x


# bert-base's four int8 products in the form the model runs them: QKV and
# FFN-up round to the compute dtype and add their bias in the epilogue
# (form (b)); attention-out and FFN-down hand their f32 product to the
# LayerNorm (form (a))
INT8_MODEL_FORM = {"bert-base QKV": "b", "bert-base attention-out": "a",
                   "bert-base FFN-up": "b", "bert-base FFN-down": "a"}


def int8_sass(lib_path: str) -> dict:
    """Counts of the warpgroup MMA (IGMMA), TMA load (UTMALDG) and TMA store
    (UTMASTG) instructions in the built int8 library's SASS, by
    ``cuobjdump --dump-sass`` where the toolkit has it; None without it."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "--dump-sass", lib_path], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    return {op: len(re.findall(r"\b" + op + r"\b", sass))
            for op in ("IGMMA", "UTMALDG", "UTMASTG", "HMMA", "IMMA")}


def int8_kernel_phase(dev, rng):
    """Kernels 5 and 6, the activation quantization and the int8 matmul,
    through the public wrappers with a launch check, in f32 and bf16, held
    to their plain versions bit for bit (codes, scales, products): at
    bert-base's and MiniLM's four matmul shapes at M = 8,192, and at edge
    shapes (M = 1 and 37, N = 7, 8, 200, 201 and 301, K = 1, 33, 312, 600
    and 20,000, the quantize's block-per-row instance; row 0 of every x is zero, rows 1-2 hold ±amax and x·inv ties). The
    matmul is checked in both epilogue forms: (a) the f32 product, (b) the
    product in x's dtype without and with a bias; an N whose output rows
    are not a multiple of 16 bytes takes the direct-store path. bert-base's
    four shapes are timed in bf16 by graph replay in the form the model
    uses (INT8_MODEL_FORM): the matmul kernel alone on the codes, the
    quantize kernel, both together, the plain version, ``torch._int_mm``
    on the same codes plus the same epilogue in torch ops (library_ms),
    cuBLAS bf16 on the dequantized W (``torch.addmm`` with the bias in
    form (b)) and the bf16 q4_matmul at the same shape. bert-base's QKV is
    each kernel's row in the JSON line."""
    import numpy as np
    import torch

    from bert_tpu_torch import _kernels
    from bert_tpu_torch.ops import int8_matmul as I
    from bert_tpu_torch.ops import q4_matmul as Q

    log("kernels 5-6: quantize_activations_i8, int8_matmul")
    sass = int8_sass(_kernels.lib_path("int8_matmul"))
    log("  int8_matmul SASS instruction counts: "
        + ("not read (no cuobjdump)" if sass is None else str(sass)))
    if sass is not None:
        require(sass["IGMMA"] > 0 and sass["UTMALDG"] > 0
                and sass["UTMASTG"] > 0 and sass["IMMA"] == 0,
                f"int8_matmul: the library is not the wgmma/TMA design: "
                f"{sass}")
    dtypes = (("f32", torch.float32), ("bf16", torch.bfloat16))
    errs = {"quantize_activations_i8": 0.0, "int8_matmul": 0.0}

    def weight(k, n):
        it = I.quantize_w8((rng.standard_normal((k, n)) * 0.02).astype(
            np.float32))
        return it, I.to_device(it, dev)

    def check(x, w, what):
        dn = "bf16" if x.dtype == torch.bfloat16 else "f32"
        q0, m0 = I.quantize_activations_i8.launches, I.int8_matmul.launches
        codes, sx = I.quantize_activations_i8(x)
        require(I.quantize_activations_i8.launches == q0 + 1,
                f"quantize_activations_i8 {what}: no launch")
        want_codes, want_sx = I.quantize_activations_i8_plain(x)
        torch.cuda.synchronize()
        n_codes = int((codes != want_codes).sum())
        n_sx = int((sx != want_sx).sum())
        require(n_codes == 0 and n_sx == 0,
                f"quantize_activations_i8 {what}: {n_codes} codes and "
                f"{n_sx} scales differ from the plain version")
        log(f"  ok  quantize_activations_i8 {what:38s} codes and scales "
            "equal (tol 0)")
        bias = torch.from_numpy(rng.standard_normal(w.n).astype(
            np.float32)).to(dev).to(x.dtype)
        for i, (form, b, out_dtype) in enumerate((
                ("(a)", None, torch.float32), ("(b)", None, x.dtype),
                ("(b)+bias", bias, x.dtype))):
            out = I.int8_matmul(x, w, b, out_dtype)
            require(I.int8_matmul.launches == m0 + 1 + i
                    and I.quantize_activations_i8.launches == q0 + 2 + i,
                    f"int8_matmul {what} {form}: the wrapper did not launch "
                    "both kernels")
            ref = I.int8_matmul_plain(x, w, b, out_dtype)
            require(out.dtype == out_dtype, f"int8_matmul {what} {form}: "
                    f"dtype {out.dtype}")
            err = compare("int8_matmul", out, ref, dn, f"{what} {form}")
            require(torch.equal(out, ref),
                    f"int8_matmul {what} {form}: not bit-exact")
            errs["int8_matmul"] = max(errs["int8_matmul"], err)

    shapes = [(8192, 768, 2304, "bert-base QKV"),
              (8192, 768, 768, "bert-base attention-out"),
              (8192, 768, 3072, "bert-base FFN-up"),
              (8192, 3072, 768, "bert-base FFN-down"),
              (8192, 384, 1152, "MiniLM QKV"),
              (8192, 384, 384, "MiniLM attention-out"),
              (8192, 384, 1536, "MiniLM FFN-up"),
              (8192, 1536, 384, "MiniLM FFN-down"),
              # edges: one row, ragged M/N, K = 1 and 33 (element loads),
              # rubert-tiny2's K = 312 and 600 (padded to 320 and 608);
              # N = 7, 201 and 301 store directly (rows of 14, 402 and 602
              # bytes in bf16; 804 and 1,204 in f32)
              (1, 1, 8, ""), (37, 1, 200, ""), (37, 33, 200, ""),
              (1, 312, 200, ""), (37, 600, 8, ""), (37, 312, 600, ""),
              (1, 600, 312, ""), (37, 33, 201, "direct stores"),
              (1, 600, 7, "direct stores"),
              (300, 320, 301, "direct stores"),
              # rows past the registers: quantize_wide_kernel
              (5, 20000, 8, "block-per-row quantize")]
    for (m, k, n, what) in shapes:
        _, w = weight(k, n)
        x32 = int8_activations(rng, m, k)
        for dn, dt in dtypes:
            x = torch.from_numpy(x32).to(dev).to(dt)
            check(x, w, f"M,K,N={m},{k},{n} {dn}"
                  + (f" ({what})" if what else ""))
        torch.cuda.synchronize()

    bf16 = torch.bfloat16
    timed, quant_timed = [], []
    for (m, k, n, what) in shapes[:4]:
        form = INT8_MODEL_FORM[what]
        it, w = weight(k, n)
        x = torch.from_numpy(int8_activations(rng, m, k)).to(dev).to(bf16)
        codes, sx = I.quantize_activations_i8(x)
        w_t = w.w_nk.t()  # [Kp, N], K contiguous: _int_mm's column-major B
        w_deq = torch.from_numpy(I.dequantize_w8(it)).to(dev).to(bf16)
        qd = q4_weights(rng, k, n, 2, dev)
        kp = w.kp
        if form == "b":
            b = torch.from_numpy(rng.standard_normal(n).astype(
                np.float32)).to(dev).to(bf16)
            od, out_bytes = bf16, 2 * m * n + 2 * n

            def library():
                return I._epilogue(torch._int_mm(codes, w_t), sx,
                                   w.scale).to(bf16) + b

            def cublas():
                return torch.addmm(b, x, w_deq)
        else:
            b, od, out_bytes = None, torch.float32, 4 * m * n

            def library():
                return I._epilogue(torch._int_mm(codes, w_t), sx, w.scale)

            def cublas():
                return torch.matmul(x, w_deq)
        nbytes = m * kp + n * kp + 4 * m + 4 * n + out_bytes
        b_ms, b_by = bound(nbytes, 2.0 * m * k * n, "int8")
        lib_exact = bool(torch.equal(library(), I.int8_matmul_codes(
            codes, sx, w, b, od)))
        r = dict(shape=f"M={m} K={k} N={n} bf16 x, form ({form}) "
                       f"({what})",
                 form=form,
                 ms=time_ms(lambda: I.int8_matmul_codes(codes, sx, w, b,
                                                        od)),
                 eager_ms=eager_ms(lambda: I.int8_matmul_codes(codes, sx, w,
                                                               b, od)),
                 with_quantize_ms=time_ms(lambda: I.int8_matmul(x, w, b,
                                                                od)),
                 plain_ms=time_ms(lambda: I.int8_matmul_plain(x, w, b, od)),
                 library_ms=time_ms(library),
                 int_mm_alone_ms=time_ms(lambda: torch._int_mm(codes, w_t)),
                 dense_bf16_matmul_ms=time_ms(cublas),
                 q4_matmul_bf16_ms=time_ms(lambda: Q.q4_matmul(x, qd)),
                 bound_ms=b_ms, bound_by=b_by, library_bit_exact=lib_exact,
                 max_abs_err=errs["int8_matmul"])
        log(f"  {r['shape']}: int8 kernel {r['ms']:.5f} ms (eager "
            f"{r['eager_ms']:.5f}; with the quantize "
            f"{r['with_quantize_ms']:.5f}), plain {r['plain_ms']:.5f}, "
            f"_int_mm + epilogue {r['library_ms']:.5f} (_int_mm alone "
            f"{r['int_mm_alone_ms']:.5f}; bit-exact with the kernel: "
            f"{lib_exact}), cuBLAS bf16 {r['dense_bf16_matmul_ms']:.5f}, "
            f"q4_matmul bf16 {r['q4_matmul_bf16_ms']:.5f}, bound "
            f"{b_ms:.5f} ({b_by}) = {100 * b_ms / r['ms']:.1f}% of it")
        timed.append(r)
        qbytes = m * k * 2 + m * kp + 4 * m
        q_ms, q_by = bound(qbytes, 4.0 * m * k, "f32")
        rq = dict(shape=f"M={m} K={k} bf16 ({what} input)",
                  ms=time_ms(lambda: I.quantize_activations_i8(x)),
                  eager_ms=eager_ms(lambda: I.quantize_activations_i8(x)),
                  plain_ms=time_ms(lambda: I.quantize_activations_i8_plain(
                      x)),
                  library_ms=None, bound_ms=q_ms, bound_by=q_by,
                  max_abs_err=0.0)
        log(f"  {rq['shape']}: quantize kernel {rq['ms']:.5f} ms (eager "
            f"{rq['eager_ms']:.5f}), plain {rq['plain_ms']:.5f}, bound "
            f"{q_ms:.5f} ({q_by})")
        quant_timed.append(rq)
        del x, codes, w_deq
        torch.cuda.synchronize()
    tol = dict(tolerance=0.0)
    fold = int8_fold_phase(dev, np.random.default_rng(21))
    # the path quantizes the attention context and FFN-down's input; the
    # row is FFN-down's, the wider
    return {"int8_matmul": dict(timed[0], **tol, timed_shapes=timed,
                                sass=sass),
            "quantize_activations_i8": dict(quant_timed[3], **tol,
                                            timed_shapes=quant_timed),
            **{k: dict(v, **tol) for k, v in fold.items()}}


def int8_fold_phase(dev, rng):
    """The quantization folded into its producers, through the
    public wrappers with a launch check, f32 and bf16, bit for bit:

    * the LayerNorm's codes form: its output against the plain form's
      kernel, its codes and sx against ``quantize_rows_i8`` of that output
      (today's composition) and the plain quantization, and the output
      against ``layer_norm_plain`` at the LayerNorm's tolerance; f32 ->
      bf16, bf16 and f32 forms, with and without residual and pre_bias,
      D = 33, 312, 600, 768 and 1,280 (the block-per-row instance), M = 1,
      37, 300 and 8,192, and a zero row (a constant row, zero bias);
    * int8_matmul's form (c): against form (b) by the kernel, then
      ``F.gelu`` (today's composition) and against its plain version;
      exact and tanh GELU, at bert-base's and MiniLM's FFN-up (M = 8,192) and N = 7, 201, 301,
      600, K = 33, 312, 320, 600, M = 1, 37, 300.

    Then times each new form at M = 8,192 by graph replay beside its
    bound and what it replaces."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from bert_tpu_torch.ops import int8_matmul as I
    from bert_tpu_torch.ops import layer_norm as L

    log("int8 fold: the LayerNorm's codes form, int8_matmul's form (c)")
    dtypes = (("f32", torch.float32), ("bf16", torch.bfloat16))

    # -- the LayerNorm's codes form
    forms = (("f32->bf16", torch.float32, torch.bfloat16),
             ("bf16", torch.bfloat16, torch.bfloat16),
             ("f32", torch.float32, torch.float32))

    def ln_operands(m, d, tin, tout, res, zero_row=False):
        x = rng.standard_normal((m, d)).astype(np.float32) * 3.0
        bias = rng.standard_normal(d).astype(np.float32)
        if zero_row:
            x[0] = 1.5  # a constant row: out = bias = 0 there
            bias[:] = 0.0
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        kw = {}
        if res:
            kw = dict(residual=t(rng.standard_normal((m, d)).astype(
                np.float32)).to(tout),
                pre_bias=t(rng.standard_normal(d).astype(np.float32)))
            if zero_row:
                kw["residual"][0] = 0.0
                kw["pre_bias"].zero_()
        return (t(x).to(tin), t(rng.uniform(0.5, 1.5, d).astype(np.float32)),
                t(bias), kw)

    ln_err = 0.0
    ln_shapes = [(8192, 768), (1, 768), (37, 33), (300, 312), (37, 600),
                 (37, 1280), (1, 312), (300, 768)]
    for (m, d) in ln_shapes:
        for fname, tin, tout in forms:
            for res in (False, True):
                zero = (m, d) == (300, 768)
                x, sc, bi, kw = ln_operands(m, d, tin, tout, res, zero)
                what = (f"M,D={m},{d} {fname}" + (" +res+pre_bias" if res
                                                   else "")
                        + (" zero row" if zero else ""))
                n0, c0 = (L.fused_layer_norm.launches,
                          L.fused_layer_norm_codes.launches)
                out, codes, sx = L.fused_layer_norm_codes(
                    x, sc, bi, eps=1e-12, out_dtype=tout, **kw)
                require(L.fused_layer_norm_codes.launches == c0 + 1
                        and L.fused_layer_norm.launches == n0,
                        f"fused_layer_norm_codes {what}: no launch")
                ref = L.fused_layer_norm(x, sc, bi, eps=1e-12,
                                         out_dtype=tout, **kw)
                qk = I.quantize_activations_i8(ref.reshape(-1, d))
                qp = I.quantize_activations_i8_plain(out.reshape(-1, d))
                torch.cuda.synchronize()
                require(torch.equal(out, ref), f"fused_layer_norm_codes "
                        f"{what}: the output is not the plain form's")
                for name, (c, s) in (("quantize_rows_i8 of the output", qk),
                                     ("the plain quantization", qp)):
                    require(torch.equal(codes, c) and torch.equal(sx, s),
                            f"fused_layer_norm_codes {what}: "
                            f"{int((codes != c).sum())} codes and "
                            f"{int((sx != s).sum())} scales differ from "
                            f"{name}")
                if zero:
                    require(float(sx[0]) == 0.0 and not codes[0].any(),
                            f"fused_layer_norm_codes {what}: row 0")
                plain = L.layer_norm_plain(x.to(tout), sc, bi, 1e-12,
                                           kw.get("residual"),
                                           kw.get("pre_bias"))
                dn = "bf16" if tout == torch.bfloat16 else "f32"
                ln_err = max(ln_err, compare("fused_layer_norm", out, plain,
                                             dn, what))
    log(f"  ok  fused_layer_norm_codes at {len(ln_shapes)} shapes x 3 forms "
        "x 2: output, codes and sx bit for bit the LayerNorm kernel then "
        "quantize_rows_i8, and the plain quantization (tol 0)")

    # -- int8_matmul's form (c)
    def weight(k, n):
        return I.to_device(I.quantize_w8((rng.standard_normal((k, n))
                                          * 0.02).astype(np.float32)), dev)

    gelu_shapes = [(8192, 768, 3072, "bert-base FFN-up"),
                   (8192, 384, 1536, "MiniLM FFN-up"),
                   (1, 600, 7, "direct stores"), (37, 33, 201,
                                                  "direct stores"),
                   (300, 320, 301, "direct stores"), (37, 312, 600, ""),
                   (1, 312, 200, "")]
    for (m, k, n, what) in gelu_shapes:
        w = weight(k, n)
        x32 = int8_activations(rng, m, k)
        for dn, dt in dtypes:
            x = torch.from_numpy(x32).to(dev).to(dt)
            codes, sx = I.quantize_activations_i8(x)
            b = torch.from_numpy(rng.standard_normal(n).astype(
                np.float32)).to(dev).to(dt)
            for approx in (False, True):
                tag = (f"M,K,N={m},{k},{n} {dn} "
                       f"{'tanh' if approx else 'erf'}"
                       + (f" ({what})" if what else ""))
                g0, m0 = I.int8_matmul_gelu.launches, I.int8_matmul.launches
                h = I.int8_matmul_gelu(codes, sx, w, b, dt, approx)
                require(I.int8_matmul_gelu.launches == g0 + 1
                        and I.int8_matmul.launches == m0,
                        f"int8_matmul_gelu {tag}: no launch")
                comp = F.gelu(I.int8_matmul_codes(codes, sx, w, b, dt),
                              approximate="tanh" if approx else "none")
                hp = I.int8_matmul_gelu_plain(codes, sx, w, b, dt, approx)
                torch.cuda.synchronize()
                for name, want in (("form (b) then F.gelu", comp),
                                   ("the plain version", hp)):
                    require(torch.equal(h, want),
                            f"int8_matmul_gelu {tag}: "
                            f"{int((h != want).sum())} values differ from "
                            f"{name}, max|Δ| "
                            f"{float((h.float() - want.float()).abs().max())}")
        del w
        torch.cuda.synchronize()
    log(f"  ok  int8_matmul_gelu at {len(gelu_shapes)} shapes, f32 and bf16, "
        "erf and tanh: bit for bit form (b) then F.gelu, and the plain "
        "version (tol 0)")

    # -- timings, bf16, M = 8,192 (graph replay)
    bf16 = torch.bfloat16
    m = 8192
    d = 768
    x, sc, bi, kw = ln_operands(m, d, torch.float32, bf16, True)
    kp = I.round_up(d, I.KP_ALIGN)
    # x f32, residual bf16 in; out bf16, codes, sx out; three [D] params
    # (scale, bias, pre_bias)
    ln_ms, ln_by = bound(m * d * (4 + 2 + 2) + m * kp + 4 * m + 3 * 4 * d,
                         10.0 * m * d, "f32")
    codes_form = lambda: L.fused_layer_norm_codes(x, sc, bi, eps=1e-12,
                                                  out_dtype=bf16, **kw)
    plain_form = lambda: L.fused_layer_norm(x, sc, bi, eps=1e-12,
                                            out_dtype=bf16, **kw)
    out0 = plain_form()

    def composition():
        out = plain_form()
        return I.quantize_activations_i8(out)
    xe, sce, bie, _ = ln_operands(m, d, bf16, bf16, False)
    ln_row = dict(
        shape=f"M={m} D={d} f32 x -> bf16, +res+pre_bias, codes form",
        ms=time_ms(codes_form), eager_ms=eager_ms(codes_form),
        plain_form_ms=time_ms(plain_form),
        # the embedding LayerNorm's: bf16 in and out, no residual
        bf16_codes_form_ms=time_ms(lambda: L.fused_layer_norm_codes(
            xe, sce, bie, eps=1e-12)),
        bf16_plain_form_ms=time_ms(lambda: L.fused_layer_norm(
            xe, sce, bie, eps=1e-12)),
        composition_ms=time_ms(composition),
        quantize_alone_ms=time_ms(lambda: I.quantize_activations_i8(out0)),
        plain_ms=time_ms(lambda: L.layer_norm_codes_plain(
            x.to(bf16), sc, bi, 1e-12, kw["residual"], kw["pre_bias"])),
        library_ms=None, bound_ms=ln_ms, bound_by=ln_by,
        max_abs_err=ln_err)
    log(f"  {ln_row['shape']}: {ln_row['ms']:.5f} ms (eager "
        f"{ln_row['eager_ms']:.5f}); the plain form "
        f"{ln_row['plain_form_ms']:.5f} "
        f"({ln_row['ms'] / ln_row['plain_form_ms']:.2f}x); the plain form "
        f"then quantize_rows_i8 {ln_row['composition_ms']:.5f}; bf16 in, "
        f"no residual (the embedding's): codes form "
        f"{ln_row['bf16_codes_form_ms']:.5f}, plain form "
        f"{ln_row['bf16_plain_form_ms']:.5f}; plain "
        f"{ln_row['plain_ms']:.5f}; bound {ln_ms:.5f} ({ln_by}) = "
        f"{100 * ln_ms / ln_row['ms']:.1f}% of it")

    k, n = 768, 3072
    w = weight(k, n)
    xq = torch.from_numpy(int8_activations(rng, m, k)).to(dev).to(bf16)
    codes, sx = I.quantize_activations_i8(xq)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        dev).to(bf16)
    w_t = w.w_nk.t()
    kp = w.kp
    c_ms, c_by = bound(m * kp + n * kp + 4 * m + 4 * n + 2 * n + 2 * m * n,
                       2.0 * m * k * n, "int8")

    def library():
        y = I._epilogue(torch._int_mm(codes, w_t), sx, w.scale).to(bf16) + b
        return F.gelu(y)

    def composition_c():
        y = I.int8_matmul_codes(codes, sx, w, b, bf16)
        h = F.gelu(y)
        return I.quantize_activations_i8(h)

    def folded_c():
        return I.quantize_activations_i8(I.int8_matmul_gelu(codes, sx, w, b,
                                                            bf16))
    gelu_row = dict(
        shape=f"M={m} K={k} N={n} bf16, form (c) (bert-base FFN-up)",
        ms=time_ms(lambda: I.int8_matmul_gelu(codes, sx, w, b, bf16)),
        eager_ms=eager_ms(lambda: I.int8_matmul_gelu(codes, sx, w, b,
                                                     bf16)),
        tanh_ms=time_ms(lambda: I.int8_matmul_gelu(codes, sx, w, b, bf16,
                                                   True)),
        form_b_ms=time_ms(lambda: I.int8_matmul_codes(codes, sx, w, b,
                                                      bf16)),
        form_b_gelu_quantize_ms=time_ms(composition_c),
        form_c_quantize_ms=time_ms(folded_c),
        plain_ms=time_ms(lambda: I.int8_matmul_gelu_plain(codes, sx, w, b,
                                                          bf16)),
        library_ms=time_ms(library), bound_ms=c_ms, bound_by=c_by,
        max_abs_err=0.0)
    log(f"  {gelu_row['shape']}: {gelu_row['ms']:.5f} ms (eager "
        f"{gelu_row['eager_ms']:.5f}; tanh {gelu_row['tanh_ms']:.5f}); form "
        f"(b) {gelu_row['form_b_ms']:.5f}; FFN-up to FFN-down's codes: "
        f"(b) + F.gelu + quantize {gelu_row['form_b_gelu_quantize_ms']:.5f}"
        f", (c) + quantize {gelu_row['form_c_quantize_ms']:.5f}; "
        f"plain {gelu_row['plain_ms']:.5f}; _int_mm + epilogue + F.gelu "
        f"{gelu_row['library_ms']:.5f}; bound {c_ms:.5f} ({c_by}) = "
        f"{100 * c_ms / gelu_row['ms']:.1f}% of it")
    del w, x, xq
    torch.cuda.synchronize()
    return {"fused_layer_norm_codes": ln_row, "int8_matmul_gelu": gelu_row}


def int8_request(rng):
    """One request: 64 sentences of 65-128 tokens (one 64x128 bucketed
    batch, 8,192 padded tokens: the int8 regime) and 8 of at most 64 (one
    packed batch of 8x64 rows: Q4). A word of the fixture vocab is one
    token, so n words make n + 3 tokens ([CLS], the period, [SEP])."""
    words = sorted(_WORDS)

    def sentence(n):
        return " ".join(rng.choice(words, size=n)) + "."

    return ([sentence(int(n)) for n in rng.integers(62, 126, size=64)]
            + [sentence(int(n)) for n in rng.integers(4, 62, size=8)])


def int8_path(dev, rng, counters):
    """The int8 regime at bert-base width: kernel checks and timings
    (:func:`int8_kernel_phase`), then a seed-0 bert-base Q4_0 file loaded
    with ``int8_eval=True`` at the default threshold, requests that take
    both regimes, launch gates, the rate beside ``int8_eval=False``, a
    profile, and agreement."""
    import numpy as np
    import torch

    from bert_tpu_torch import BertTorch
    from bert_tpu_torch.formats import GgmlHParams, write_ggml
    from bert_tpu_torch.loader import load_model
    from bert_tpu_torch.ops import int8_matmul as I
    from bert_tpu_torch.params import BertConfig, random_named_tensors

    t_phase = time.perf_counter()
    results = int8_kernel_phase(dev, rng)
    log(f"int8 path: kernel checks and timings in "
        f"{time.perf_counter() - t_phase:.2f} s")

    cfg = BertConfig(**BERT_BASE)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "bert_base_q4_0.bin")
    t0 = time.perf_counter()
    hp = GgmlHParams(cfg.n_vocab, cfg.n_max_tokens, cfg.n_embd,
                     cfg.n_intermediate, cfg.n_head, cfg.n_layer, ftype=2)
    write_ggml(path, hp, fixture_tokens(cfg.n_vocab),
               random_named_tensors(cfg, 0))
    t_write = time.perf_counter() - t0
    log(f"int8 path: wrote a bert-base q4_0 ggml file from seed 0 in "
        f"{t_write:.2f} s ({os.path.getsize(path) / 1e6:.1f} MB)")

    t0 = time.perf_counter()
    model = BertTorch.from_file(path, int8_eval=True)  # threshold 8,192
    log(f"int8 path: BertTorch.from_file(int8_eval=True) -> {model.device}, "
        f"{model.compute_dtype}, wire {model.wire_dtype} in "
        f"{time.perf_counter() - t0:.2f} s; load phases "
        f"{model.stats()['load_phases']}")
    require(model.model_int8 is not None and model.device.type == "cuda",
            "int8 path: from_file(int8_eval=True) built no int8 model")
    threshold = model._int8_threshold
    requests = [int8_request(rng) for _ in range(6)]
    lengths = [len(t) for t in model.tokenizer.tokenize_batch(
        requests[0], cfg.n_max_tokens)]
    require(all(65 <= n <= 128 for n in lengths[:64])
            and all(n <= 64 for n in lengths[64:]),
            f"int8 path: request lengths {min(lengths)}..{max(lengths)} do "
            "not take one 64x128 batch and one packed batch")
    warm, counted = requests[:2], requests[2:]
    for r in warm:
        model.encode_batch(r)
    torch.cuda.synchronize()

    def run(engine):
        timed = timed_start(engine)
        outs, lat = [], []
        for r in counted:
            t0 = time.perf_counter()
            outs.append(engine.encode_batch(r))
            lat.append(time.perf_counter() - t0)
        n_sent = sum(len(r) for r in counted)
        timed_end(engine, timed, lat, n_sent)
        return outs, n_sent / sum(lat), lat, timed

    batches0 = dict(model.timers.bucket_counts)
    for c in counters:
        c.launches = 0
    outs, rate, lat, timed = run(model)
    launches = {c.__name__: c.launches for c in counters}
    ran = {k: n - batches0.get(k, 0)
           for k, n in model.timers.bucket_counts.items()
           if n > batches0.get(k, 0)}
    int8_batches = sum(n for (rows, t, _), n in ran.items()
                       if rows * t >= threshold)
    q4_batches = sum(ran.values()) - int8_batches
    log(f"int8 path: {len(counted)} warm requests of {len(counted[0])} "
        f"sentences = {rate:.1f} sentences/s; request latency median "
        f"{statistics.median(lat) * 1e3:.3f} ms, max {max(lat) * 1e3:.3f} ms "
        f"({gpu_line()})")
    log(f"int8 path buckets: {ran} ({int8_batches} int8 batches at >= "
        f"{threshold} padded tokens, {q4_batches} Q4)")
    log(f"int8 path kernel launches: {launches}")
    per = 4 * cfg.n_layer
    n_layer = cfg.n_layer
    require(int8_batches == len(counted) and q4_batches == len(counted),
            "int8 path: each request did not run one int8 and one Q4 batch")
    # an int8 batch, folded: QKV (b), attention-out (a) and FFN-down (a)
    # by int8_matmul, FFN-up by form (c); the attention context and
    # FFN-down's input quantized on their own; the
    # embedding LayerNorm and all but the last layer's output LayerNorm,
    # and every attention LayerNorm, in the codes form
    want = {"int8_matmul": 3 * n_layer, "int8_matmul_gelu": n_layer,
            "quantize_activations_i8": 2 * n_layer,
            "fused_layer_norm_codes": 2 * n_layer}
    for name, n in want.items():
        require(launches[name] == n * int8_batches,
                f"int8 path: {name} launched {launches[name]} times, not "
                f"{n} per int8 batch ({int8_batches})")
    require(launches["fused_layer_norm"]
            == int8_batches + (2 * n_layer + 1) * q4_batches,
            f"int8 path: fused_layer_norm launched "
            f"{launches['fused_layer_norm']} times, not once per int8 "
            f"batch (the last layer's) and {2 * n_layer + 1} per Q4 batch")
    require(launches["q4_matmul"] == per * q4_batches,
            "int8 path: q4_matmul did not run the packed batches")
    require(launches["multi_head_attention"] == 0
            and launches["fused_qkv_attention"] == 2 * cfg.n_layer
            * len(counted),
            "int8 path: bert-base's d_head 64 did not take the fused "
            "attention")
    families = (("int8_matmul", ("int8_matmul_kernel",)),
                ("quantize_i8", ("quantize_rows_kernel",
                                 "quantize_wide_kernel")),
                ("gelu", ("GeluCUDAKernelImpl",)),
                # the LayerNorm's codes instances: CODES, the last
                # template argument, true
                ("ln_codes", (("ln_rows_kernel", ", true>("),
                              ("ln_block_kernel", ", true>("))),
                ("q4_matmul", (("q4_matmul", "(__nv_bfloat16 const*"),)))
    prof = profile_request(model, counted[0], "int8 path", extra=families)

    # the same requests with the int8 regime off
    t0 = time.perf_counter()
    q4 = BertTorch.from_file(path)
    log(f"int8 path: BertTorch.from_file(int8_eval=False) in "
        f"{time.perf_counter() - t0:.2f} s")
    for r in warm:
        q4.encode_batch(r)
    torch.cuda.synchronize()
    q4_outs, q4_rate, q4_lat, q4_timed = run(q4)
    log(f"int8 path, int8_eval=False: {q4_rate:.1f} sentences/s; request "
        f"latency median {statistics.median(q4_lat) * 1e3:.3f} ms, max "
        f"{max(q4_lat) * 1e3:.3f} ms (int8_eval=True: {rate:.1f} "
        f"sentences/s, {statistics.median(lat) * 1e3:.3f} ms; "
        f"{gpu_line()})")
    q4_prof = profile_request(q4, counted[0], "int8 path, int8_eval=False",
                              extra=families)
    graphs = {"int8 path": graphs_phase(model, "int8 path", counted[0],
                                        prof, timed),
              "int8 path, int8_eval=False": graphs_phase(
                  q4, "int8 path, int8_eval=False", counted[0], q4_prof,
                  q4_timed)}

    if prof is not None and q4_prof is not None:
        log(f"int8 path, one request profiled: int8_eval on "
            f"{prof['device_busy_us'] / 1e3:.3f} ms of device time in "
            f"{prof['kernels']} kernels ({prof['bf16_casts']} bf16 casts), "
            f"off {q4_prof['device_busy_us'] / 1e3:.3f} ms in "
            f"{q4_prof['kernels']} ({q4_prof['bf16_casts']} casts); "
            f"GELU {prof['gelu_launches']} launches on, "
            f"{q4_prof['gelu_launches']} off; quantize "
            f"{prof['quantize_i8_launches']} on; the unfolded quantizer "
            "(NVIDIA H100 80GB HBM3, 700 W, PERF.md): on 5.539-5.578 ms in "
            "386-387 kernels, off 12.450-12.667 ms in 386")
        # the int8 batch launches no GELU and quantizes only the attention
        # context and FFN-down's input; the packed Q4 batch keeps its L
        # GELUs
        require(prof["gelu_launches"] == n_layer
                and q4_prof["gelu_launches"] == 2 * n_layer,
                f"int8 path: GELU launched {prof['gelu_launches']} times "
                f"with int8_eval on, {q4_prof['gelu_launches']} off: a "
                "standalone GELU is left in the int8 batch")
        require(prof["ln_codes_launches"] == 2 * n_layer
                and q4_prof["ln_codes_launches"] == 0,
                f"int8 path: the LayerNorm's codes form launched "
                f"{prof['ln_codes_launches']} times with int8_eval on, "
                f"{q4_prof['ln_codes_launches']} off, not 2L and 0")
        require(prof["quantize_i8_launches"] == 2 * n_layer,
                f"int8 path: {prof['quantize_i8_launches']} quantize "
                "launches in the profiled request, not 2L: a standalone "
                "quantize of a QKV or FFN-up input is left")
        # a Q4 batch casts its QKV and FFN-up products and their biases to
        # bf16 (4 casts a layer); the int8 batch's epilogue rounds the
        # products itself, so only the two bias casts a layer remain
        require(prof["bf16_casts"] == q4_prof["bf16_casts"] - 2 * cfg.n_layer,
                f"int8 path: {prof['bf16_casts']} bf16 casts with int8_eval "
                f"on, {q4_prof['bf16_casts']} off: the int8 products are "
                "still cast apart")

    for req, emb, ref in zip(counted, outs, q4_outs):
        require(emb.shape == (len(req), cfg.n_embd)
                and bool(np.isfinite(emb).all()),
                f"int8 path: bad embeddings {emb.shape}")
        norms = np.linalg.norm(emb, axis=-1)
        require(bool(np.all(np.abs(norms - 1.0) < 1e-2)),
                f"int8 path: norms off 1: {norms.min():.4f}")
    cos_q4 = np.concatenate([np.sum(a * b, axis=-1)
                             for a, b in zip(outs, q4_outs)])
    log(f"int8 path: int8 (card bf16) vs Q4 (card bf16), every sentence: "
        f"min cos {cos_q4.min():.6f} (the int8 batch's {cos_q4[:64].min():.6f}"
        f", the Q4 batch's {cos_q4[64:].min():.6f})")
    require(bool(np.all(cos_q4 > 0.999)), "int8 path: int8 vs Q4 cos <= 0.999")

    # a small request, int8 everywhere: the card's f32 against the CPU's
    small = counted[0][:3] + counted[0][64:67]
    t0 = time.perf_counter()
    loaded = load_model(path)
    cpu = BertTorch(loaded, device="cpu", int8_eval=True, int8_threshold=0)
    ref = cpu.encode_batch(small)
    log(f"int8 path: CPU f32 int8 reference in {time.perf_counter() - t0:.2f}"
        " s")
    g32 = BertTorch(loaded, device="cuda", compute_dtype=torch.float32,
                    int8_eval=True, int8_threshold=0)
    i0 = I.int8_matmul.launches
    e32 = g32.encode_batch(small)
    require(I.int8_matmul.launches > i0,
            "int8 path: the card f32 int8 engine launched no int8 kernel")
    cos32 = np.sum(e32 * ref, axis=-1)
    err32 = float(np.abs(e32 - ref).max())
    log(f"int8 path: card f32 int8 vs CPU f32 int8 (threshold 0): min cos "
        f"{cos32.min():.7f}, max|Δ| {err32:.3e}")
    require(bool(np.all(cos32 > 0.9999)), "int8 path: card f32 cos <= 0.9999")
    require(err32 <= 5e-3, "int8 path: card f32 max|Δ| > 5e-3")
    t_all = time.perf_counter() - t_phase
    log(f"int8 path: the phase took {t_all:.2f} s, {t_write:.2f} s of it "
        "writing the bert-base file")
    path_info = {"launches": launches, "rate": rate, "q4_rate": q4_rate,
                 "latency_median_ms": statistics.median(lat) * 1e3,
                 "q4_latency_median_ms": statistics.median(q4_lat) * 1e3,
                 "profile": prof, "q4_profile": q4_prof,
                 "phase_s": t_all, "write_s": t_write, "graphs": graphs}
    return results, path_info


# ---------------------------------------------------------------------------
# train path
# ---------------------------------------------------------------------------

# The train phase's learning rate: at it, 20 AdamW steps of batch 32 lower
# the InfoNCE loss of the seed-0 MiniLM-L6 weights (PERF.md). bert_tpu's
# default, 2e-5, is for pretrained weights.
TRAIN_LR = 1e-4
TRAIN_STEPS = 20


def sts_pairs_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmarks", "data", "sts_en.tsv")


def sts_tokens(n_vocab: int):
    """:func:`fixture_tokens` with each word and punctuation mark of the
    STS pairs in a free ``[unusedN]`` slot, so that the pairs tokenize to
    words rather than [UNK]."""
    tokens = fixture_tokens(n_vocab)
    free = (i for i, t in enumerate(tokens) if t.startswith("[unused"))
    with open(sts_pairs_path(), encoding="utf-8") as f:
        words = set(re.findall(r"[a-z0-9]+|[^\sa-z0-9]", f.read().lower()))
    for w in sorted(words - set(tokens)):
        tokens[next(free)] = w
    return tokens


def train_batches(loaded, n_steps: int, batch: int, seq: int):
    """The batches ``finetune.main`` draws with its defaults: the positive
    pairs (score >= 3.5) of the STS file, tokenized as it tokenizes them,
    through its :func:`draw_batches`."""
    from bert_tpu_torch import finetune
    from bert_tpu_torch.tokenizer import WordPieceTokenizer

    s1, s2, gold = finetune.read_sts_pairs(sts_pairs_path())
    keep = [i for i, g in enumerate(gold) if g >= 3.5]
    tok = WordPieceTokenizer(loaded.vocab)
    toks_a, toks_b = ([tok.tokenize(s[i], seq) for i in keep]
                      for s in (s1, s2))
    return list(finetune.draw_batches(toks_a, toks_b, n_steps, batch, seq))


def new_train_state(loaded, dev, lr: float):
    """A fresh TrainState over the file's dense f32 weights on ``dev``."""
    from bert_tpu_torch.model import TrainableBertModel
    from bert_tpu_torch.params import params_to_torch
    from bert_tpu_torch.train import init_train_state, make_optimizer

    opt = make_optimizer(lr)
    model = TrainableBertModel(params_to_torch(loaded.params, device=dev),
                               loaded.config)
    return opt, init_train_state(model, opt)


def card_vs_cpu_steps(loaded, lr: float, n_steps: int = 3, batch: int = 8,
                      seq: int = 64) -> dict:
    """``n_steps`` make_train_step steps (f32, remat) on the CPU and then on
    the card, from the same weights and batches. Each step: loss within
    1e-4 and grad_norm within 1e-3 of the CPU's (relative: the card sums
    in other orders, and the embedding backward accumulates with atomics);
    each leaf's AdamW first moment within 1e-3 of its largest; parameters
    within the rule of :func:`bert_tpu_torch.testing.noise_rule` (the one
    the CPU tests hold the port to against bert_tpu), qkv_b's key lanes
    exempt."""
    import numpy as np
    import torch

    from bert_tpu_torch.params import params_to_numpy
    from bert_tpu_torch.testing import key_bias_lanes, noise_rule
    from bert_tpu_torch.train import make_train_step

    batches = train_batches(loaded, n_steps, batch, seq)
    runs = {}
    for dev in ("cpu", "cuda"):
        opt, state = new_train_state(loaded, torch.device(dev), lr)
        step = make_train_step(loaded.config, opt)
        rows = []
        for b in batches:
            state, m = step(state, b)
            tree = state.params.tree()
            # a copy: on the CPU .numpy() would view the live moment
            mu = {g: {k: state.opt_state.state[p]["exp_avg"].cpu().numpy()
                      .copy() for k, p in sub.items()}
                  for g, sub in tree.items()}
            rows.append((float(m["loss"]), float(m["grad_norm"]),
                         params_to_numpy(state.params), mu))
        runs[dev] = rows
        del opt, state
    worst = {"loss_rel": 0.0, "grad_norm_rel": 0.0, "param_max_abs": 0.0,
             "param_max_abs_outside_noise": 0.0,
             "param_max_abs_key_bias": 0.0}
    noisy, keys = None, key_bias_lanes(loaded.config)
    for s, (cpu, card) in enumerate(zip(runs["cpu"], runs["cuda"]), 1):
        loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
        gn_rel = abs(card[1] - cpu[1]) / abs(cpu[1])
        log(f"train: step {s} batch {batch}: loss card {card[0]:.7f} / CPU "
            f"{cpu[0]:.7f} (rel {loss_rel:.2e}), grad_norm card "
            f"{card[1]:.6f} / CPU {cpu[1]:.6f} (rel {gn_rel:.2e})")
        require(np.isfinite([card[0], card[1]]).all(),
                f"train: step {s} on the card is not finite")
        require(loss_rel <= 1e-4, f"train: step {s} loss rel {loss_rel:.2e}")
        require(gn_rel <= 1e-3, f"train: step {s} grad_norm rel {gn_rel:.2e}")
        worst["loss_rel"] = max(worst["loss_rel"], loss_rel)
        worst["grad_norm_rel"] = max(worst["grad_norm_rel"], gn_rel)
        if noisy is None:
            noisy = {g: {k: np.zeros(v.shape, bool) for k, v in sub.items()}
                     for g, sub in cpu[3].items()}
        leaves = {}
        for g, sub in cpu[2].items():
            for k, want in sub.items():
                mu, mu_card = cpu[3][g][k], card[3][g][k]
                mu_err = float(np.abs(mu_card - mu).max())
                require(mu_err <= 1e-3 * float(np.abs(mu).max()),
                        f"train: step {s} {g}/{k}: first moment max|Δ| "
                        f"{mu_err:.3e}")
                try:
                    r = noise_rule(card[2][g][k], want, mu_card, mu,
                                   noisy[g][k], lr, s, f"{g}/{k}",
                                   exempt=keys if k == "qkv_b" else None)
                except AssertionError as e:
                    raise SmokeFailure(f"train: step {s} {e}") from None
                leaves[f"{g}/{k}"] = r
                worst["param_max_abs"] = max(worst["param_max_abs"],
                                             r["max_abs"])
                worst["param_max_abs_outside_noise"] = max(
                    worst["param_max_abs_outside_noise"],
                    r["max_abs_outside_noise"])
                worst["param_max_abs_key_bias"] = max(
                    worst["param_max_abs_key_bias"], r["max_abs_exempt"])
        worst["leaves"] = leaves
    log(f"train: card vs CPU over {n_steps} steps (lr {lr}): params max|Δ| "
        f"{worst['param_max_abs']:.3e}; outside the noise "
        f"{worst['param_max_abs_outside_noise']:.3e}; qkv_b's key lanes "
        f"{worst['param_max_abs_key_bias']:.3e}")
    for name, r in worst["leaves"].items():
        keys = f", {r['exempt']} key lanes exempt" if r["exempt"] else ""
        log(f"  {name}: {r['noise']} of {r['size']} elements noise (first "
            f"moments > 1e-3 apart), {r['beyond']} beyond 1e-6 (max|Δ| "
            f"{r['max_abs']:.3e}, {r['max_abs_outside_noise']:.3e} outside "
            f"the noise){keys}")
    return worst


def measure_steps(loaded, dev, lr: float, batches, compute_dtype,
                  remat: bool) -> dict:
    """make_train_step on the card over ``batches`` from a fresh state:
    each step's host-clock time (the step and the read of its loss, which
    waits for the card) and its peak of allocated device memory above what
    was resident before the state was built (earlier phases' leftovers),
    so parameters, moments, gradients and activations."""
    import gc

    import torch

    from bert_tpu_torch.train import make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    opt, state = new_train_state(loaded, dev, lr)
    step = make_train_step(loaded.config, opt, compute_dtype=compute_dtype,
                           remat=remat)
    ms, peak, losses = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        peak.append(torch.cuda.max_memory_allocated() - base)
    del opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_bytes": peak, "losses": losses,
            "resident_before_bytes": base}


def profile_train_step(loaded, dev, lr: float, batches) -> dict:
    """torch.profiler over one warm f32 remat step: device time by family
    of kernel against the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bert_tpu_torch.train import make_train_step

    opt, state = new_train_state(loaded, dev, lr)
    step = make_train_step(loaded.config, opt)
    state, m = step(state, batches[0])
    float(m["loss"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batches[1])
        float(m["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the optimizer's step annotation spans its kernels: not one itself
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        log("train profile: device time not measured (the profiler saw no "
            "CUDA kernel time)")
        return {}
    families = (("cuBLAS GEMMs", ("gemm", "xmma", "cutlass", "splitK")),
                ("embedding backward (sort + scatter)",
                 ("indexing_backward", "index_put", "adix", "scatter",
                  "embedding")),
                ("optimizer (foreach AdamW)", ("multi_tensor_apply",)),
                ("softmax", ("softmax",)),
                ("reductions", ("reduce_kernel",)),
                ("elementwise", ("elementwise_kernel",)))
    sums = {name: [0.0, 0] for name, _ in families + (("other", ()),)}
    for e in kernels:
        fam = next((name for name, keys in families
                    if any(k in e.key for k in keys)), "other")
        sums[fam][0] += e.self_device_time_total
        sums[fam][1] += e.count
    n = sum(e.count for e in kernels)
    log(f"train profile of one f32 remat step (batch {len(batches[1]['ids_a'])}"
        f", seq {batches[1]['ids_a'].shape[1]}): wall {wall_us:.1f} us, "
        f"device busy {busy_us:.1f} us = {100 * busy_us / wall_us:.1f}% in "
        f"{n} kernels ({gpu_line()})")
    for name, (us, c) in sums.items():
        log(f"  {name}: {us:.1f} us ({100 * us / busy_us:.1f}%) / {c} "
            "launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total:10.1f} us {e.count:5d}x  "
            f"{e.key[:100]}")
    return {"wall_us": wall_us, "device_busy_us": busy_us, "kernels": n,
            **{f"{k}_us": v[0] for k, v in sums.items()}}


def train_path(counters):
    """Contrastive fine-tuning at all-MiniLM-L6-v2's full width: a dense
    f32 seed-0 ggml file over a vocab that holds the STS pairs' words;
    ``finetune.main`` on the card with every kernel counter at 0 (training
    runs the plain versions: none may launch); the first steps on the card
    against the CPU; step time, memory with and without remat, a bf16 step
    and a profile; then the tuned .npz served on the card through the
    LayerNorm and fused attention kernels, against the CPU."""
    import numpy as np
    import torch

    from bert_tpu_torch import BertTorch, finetune
    from bert_tpu_torch.formats import GgmlHParams, write_ggml
    from bert_tpu_torch.loader import load_model
    from bert_tpu_torch.params import BertConfig, random_named_tensors

    t_phase = time.perf_counter()
    card = gpu_line()
    cfg = BertConfig(**MINILM_L6)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "minilm_l6_f32.bin")
    out = os.path.join(work, "minilm_l6_tuned.npz")
    t0 = time.perf_counter()
    hp = GgmlHParams(cfg.n_vocab, cfg.n_max_tokens, cfg.n_embd,
                     cfg.n_intermediate, cfg.n_head, cfg.n_layer, ftype=0)
    write_ggml(path, hp, sts_tokens(cfg.n_vocab), random_named_tensors(cfg, 0))
    log(f"train: wrote a MiniLM-L6 f32 ggml file from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({os.path.getsize(path) / 1e6:.1f} MB)")
    loaded = load_model(path)
    batch, seq = 32, 64
    batches = train_batches(loaded, TRAIN_STEPS, batch, seq)
    ids = np.concatenate([b[f"ids_{s}"] for b in batches for s in "ab"])
    n_tok = int((ids > 0).sum())
    unk = int((ids == 100).sum())
    log(f"train: {TRAIN_STEPS} batches of {batch} pairs, {n_tok} tokens "
        f"({100 * n_tok / ids.size:.1f}% of the padded {ids.size}), "
        f"{unk} [UNK]")
    require(unk <= 0.01 * n_tok, f"train: {unk} [UNK] of {n_tok} tokens")

    # the entry point on the card: no kernel may launch while it trains
    for c in counters:
        c.launches = 0
    r = finetune.main(["-m", path, "--steps", str(TRAIN_STEPS), "--batch",
                       str(batch), "--seq", str(seq), "--lr", str(TRAIN_LR),
                       "--out", out])
    launches = {c.__name__: c.launches for c in counters}
    log(f"train: kernel launches during finetune.main: {launches}")
    require(not any(launches.values()),
            f"train: kernels launched in the train steps: {launches}")
    require(bool(np.isfinite(r["losses"]).all()
                 and np.isfinite(r["grad_norms"]).all()),
            "train: a non-finite loss or grad_norm")
    require(r["last_loss"] < r["first_loss"],
            f"train: the loss did not fall: {r['first_loss']:.4f} -> "
            f"{r['last_loss']:.4f}")
    step_ms = statistics.median(r["step_ms"][2:])
    n_matmul = cfg.n_layer * (4 * cfg.n_embd ** 2
                              + 2 * cfg.n_embd * cfg.n_intermediate)
    tokens = 2 * batch * seq  # padded, both sides of each pair
    flops = 8 * n_matmul * tokens  # 6·N·tokens + 2·N·tokens of recompute
    share = flops / (step_ms * 1e-3) / PEAK_FLOPS["f32"]
    log(f"train: finetune.main on the card, f32, remat, lr {TRAIN_LR}: loss "
        f"{r['first_loss']:.4f} -> {r['last_loss']:.4f} in {TRAIN_STEPS} "
        f"steps; {step_ms:.3f} ms/step (median of steps 3-{TRAIN_STEPS}), "
        f"{batch / step_ms * 1e3:.1f} pairs/s, {tokens / step_ms * 1e3:.0f} "
        f"padded tokens/s; 8·N·tokens = {flops / 1e9:.1f} GFLOP a step (N = "
        f"{n_matmul} matmul weights) = {100 * share:.2f}% of the f32 peak "
        f"(67 TFLOP/s) ({card})")

    worst = card_vs_cpu_steps(loaded, TRAIN_LR)

    dev = torch.device("cuda")
    runs = {}
    for name, dtype, remat in (("f32 remat", torch.float32, True),
                               ("f32 no remat", torch.float32, False),
                               ("bf16 remat", torch.bfloat16, True)):
        runs[name] = measure_steps(loaded, dev, TRAIN_LR, batches[:4], dtype,
                                   remat)
        m = runs[name]
        log(f"train: {name}: {statistics.median(m['ms'][1:]):.3f} ms/step "
            f"(median of steps 2-4), peak allocated "
            f"{m['peak_bytes'][-1] / 2**20:.1f} MiB (step 4, above the "
            f"{m['resident_before_bytes'] / 2**20:.1f} MiB resident before "
            "it), losses "
            f"{' '.join(f'{x:.4f}' for x in m['losses'])} ({card})")
        require(bool(np.isfinite(m["losses"]).all()),
                f"train: {name}: a non-finite loss")
    prof = profile_train_step(loaded, dev, TRAIN_LR, batches)

    # the tuned weights, served through the kernels
    s1, s2, _ = finetune.read_sts_pairs(sts_pairs_path())
    texts = s1[:64] + s2[:64]
    served = BertTorch.from_file(out)  # the card, bf16
    require(served.device.type == "cuda", "train: from_file did not default "
            "to cuda")
    served.encode_batch(texts)  # every shape's capture
    batches0 = dict(served.timers.bucket_counts)
    for c in counters:
        c.launches = 0
    e16 = served.encode_batch(texts)
    serve_launches = {c.__name__: c.launches for c in counters}
    n_batches = sum(n - batches0.get(k, 0)
                    for k, n in served.timers.bucket_counts.items())
    log(f"train: the tuned .npz served on the card, bf16: {len(texts)} "
        f"sentences in {n_batches} batches, launches {serve_launches}")
    require(serve_launches["fused_layer_norm"]
            == (2 * cfg.n_layer + 1) * n_batches,
            "train: the LayerNorm did not launch 2L+1 times a batch")
    require(serve_launches["fused_qkv_attention"] == cfg.n_layer * n_batches,
            "train: the fused attention did not launch L times a batch")
    require(not any(serve_launches[k] for k in serve_launches
                    if k not in ("fused_layer_norm", "fused_qkv_attention")),
            "train: a kernel off the dense d_head-32 path launched")
    ref = BertTorch.from_file(out, device="cpu").encode_batch(texts)
    e32 = BertTorch.from_file(out, compute_dtype=torch.float32).encode_batch(
        texts)
    cos16, cos32 = (np.sum(e * ref, axis=-1) for e in (e16, e32))
    err32 = float(np.abs(e32 - ref).max())
    log(f"train: tuned .npz, card f32 vs CPU f32: min cos {cos32.min():.7f}, "
        f"max|Δ| {err32:.3e}; card bf16 vs CPU f32: min cos "
        f"{cos16.min():.6f}")
    require(bool(np.all(cos32 > 0.9999)), "train: card f32 cos <= 0.9999")
    require(err32 <= 5e-3, "train: card f32 max|Δ| > 5e-3")
    require(bool(np.all(cos16 > 0.999)), "train: card bf16 cos <= 0.999")
    t_all = time.perf_counter() - t_phase
    log(f"train: the phase took {t_all:.2f} s")
    return {"loss_first": r["first_loss"], "loss_last": r["last_loss"],
            "ms_per_step": step_ms, "pairs_per_s": batch / step_ms * 1e3,
            "f32_peak_share": share, "card_vs_cpu": worst,
            "steps": {k: {"ms": statistics.median(v["ms"][1:]),
                          "peak_bytes": v["peak_bytes"][-1]}
                      for k, v in runs.items()},
            "profile": prof, "phase_s": t_all}


# ---------------------------------------------------------------------------
# sharded phase: ranks that share the one card
# ---------------------------------------------------------------------------

# (dp, tp) of the MiniLM-L6 runs, by world size; rubert-tiny2 runs at tp = 2
SHARDED_MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
SHARDED_REQUESTS = 3


def ranks_label(ranks) -> str:
    """How a run's times are to be read: ranks that share one card (gloo,
    the driver's one-card machine) give no scaling figure."""
    devices = {r["device"] for r in ranks}
    backend = ranks[0]["backend"]
    if len(devices) < len(ranks):
        return (f"{len(ranks)} ranks sharing {len(devices)} card(s) over "
                f"{backend}: a time of the shared card, no scaling figure")
    return (f"{len(ranks)} ranks on cards of their own over {backend}; "
            "device time includes the collectives' waits")


def _launch_spies():
    """Record what each kernel launches on: q4_matmul's (K, N), the fused
    attention's local heads and the per-(batch, head) attention's [B, H,
    T, dh] heads. Wraps each module's launch function; the launch counts
    stay in the wrappers."""
    from bert_tpu_torch.ops import attention, fused_attention, q4_matmul

    seen = {"q4_matmul": set(), "fused_qkv_attention": set(),
            "multi_head_attention": set()}

    def spy(mod, name, shape):
        launch = mod._launch

        def recording(*args):
            seen[name].add(shape(*args))
            return launch(*args)
        mod._launch = recording

    spy(q4_matmul, "q4_matmul",
        lambda x, qt: (x.shape[1], qt.packed.shape[-1]))
    spy(fused_attention, "fused_qkv_attention", lambda *a: a[2])
    spy(attention, "multi_head_attention", lambda q, *a: q.shape[1])
    return seen


def _device_us(fn):
    """Device time of one ``fn()``: the CUDA kernels' self time that
    torch.profiler sees, or None where it sees none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:  # the profiler, not the request, failed
        log(f"device time not measured: the profiler raised {e!r}")
        return None
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA"))
    return us or None


def sharded_rank(encode_jobs, train=None):
    """One rank of the sharded phase. Each encode job loads ``path`` with
    ``BertTorch.from_file(path, dp=, tp=)`` (bf16; the mesh and its gloo
    group are formed from the launcher's environment), embeds the first
    request once (the kernels load), then embeds every request with the
    launch counts set to 0 just before and read just after; then one
    request's device time and wall time, and the first request in f32.
    ``train`` runs make_sharded_train_step at (2, 2), f32, one step per
    batch, with the counts at 0 (training runs the plain versions)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from bert_tpu_torch import BertTorch
    from bert_tpu_torch.ops.attention import multi_head_attention
    from bert_tpu_torch.ops.fused_attention import fused_qkv_attention
    from bert_tpu_torch.ops.layer_norm import fused_layer_norm
    from bert_tpu_torch.ops.q4_matmul import q4_matmul

    counters = (q4_matmul, fused_layer_norm, fused_qkv_attention,
                multi_head_attention)
    seen = _launch_spies()
    out = []
    for job in encode_jobs:
        t0 = time.perf_counter()
        model = BertTorch.from_file(job["path"], dp=job["dp"], tp=job["tp"])
        model.encode_batch(job["requests"][0])
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        for c in counters:
            c.launches = 0
        for v in seen.values():
            v.clear()
        t0 = time.perf_counter()
        embs = [model.encode_batch(r) for r in job["requests"]]
        wall = (time.perf_counter() - t0) / len(job["requests"])
        launches = {c.__name__: c.launches for c in counters}
        shapes = {k: sorted(v) for k, v in seen.items()}
        dev_us = _device_us(lambda: model.encode_batch(job["requests"][0]))
        f32 = BertTorch.from_file(job["path"], dp=job["dp"], tp=job["tp"],
                                  compute_dtype=torch.float32)
        e32 = f32.encode_batch(job["requests"][0])
        c = model.config
        out.append({"dims": (c.n_embd, c.n_intermediate, c.n_head),
                    "rank": dist.get_rank(), "device": str(model.device),
                    "backend": dist.get_backend(), "embs": embs, "e32": e32,
                    "launches": launches, "shapes": shapes,
                    "device_us": dev_us, "wall_ms": wall * 1e3,
                    "load_s": t_load, "buckets": model.stats()["buckets"]})
        del model, f32
    if train is not None:
        out.append(_sharded_train(**train))
    return out


def _sharded_train(path, lr, batches):
    import torch
    import torch.distributed as dist

    from bert_tpu_torch.loader import load_model
    from bert_tpu_torch.model import TrainableBertModel
    from bert_tpu_torch.ops.attention import multi_head_attention
    from bert_tpu_torch.ops.fused_attention import fused_qkv_attention
    from bert_tpu_torch.ops.layer_norm import fused_layer_norm
    from bert_tpu_torch.ops.q4_matmul import q4_matmul
    from bert_tpu_torch.parallel.mesh import make_mesh
    from bert_tpu_torch.params import params_to_numpy, params_to_torch
    from bert_tpu_torch.train import (adam_moments, init_train_state,
                                      make_optimizer,
                                      make_sharded_train_step)

    loaded = load_model(path)
    mesh = make_mesh(4, tp=2)
    opt = make_optimizer(lr)
    state = init_train_state(TrainableBertModel(
        params_to_torch(loaded.params, device="cpu"), loaded.config), opt)
    state, step = make_sharded_train_step(mesh, loaded.config, opt, state)
    counters = (q4_matmul, fused_layer_norm, fused_qkv_attention,
                multi_head_attention)
    for c in counters:
        c.launches = 0
    rows = []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss = float(m["loss"])  # waits for the step
        ms = (time.perf_counter() - t0) * 1e3
        params = params_to_numpy(state.params)
        mu = adam_moments(state)[0]
        keep = dist.get_rank() == 0  # the others' gathered trees are equal
        rows.append((loss, float(m["grad_norm"]), params if keep else None,
                     mu if keep else None, ms))
    return {"train": rows, "launches": {c.__name__: c.launches
                                        for c in counters}}


def _cos(a, b):
    import numpy as np

    return np.sum(a * b, axis=-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))


def sharded_path():
    """MiniLM-L6 Q4_0 (bf16, the main path's file) at tp = 2, dp = 2 and
    (2, 2), rubert-tiny2 (dense, hf_server's directory) at tp = 2, and 3
    fine-tune steps at (2, 2) (f32, the train phase's file), every rank a
    process on the one card (parallel.multihost.spawn_ranks; NCCL refuses
    two ranks on one card, so the group is gloo). Each is held to the
    single-rank result on the card: bf16 min cos > 0.999; f32 cos >
    0.9999 and max|Δ| <= 5e-3; the steps by loss (rel 1e-4), grad_norm
    (rel 1e-3) and noise_rule, as the train phase holds the card to the
    CPU. Every rank must launch q4_matmul at the shard shapes, the
    LayerNorm and the fused attention over H/tp heads (MiniLM), the
    per-(batch, head) attention over 6 heads (rubert-tiny2)."""
    import numpy as np
    import torch

    from bert_tpu_torch import BertTorch
    from bert_tpu_torch.loader import load_model
    from bert_tpu_torch.parallel.multihost import spawn_ranks
    from bert_tpu_torch.params import params_to_numpy
    from bert_tpu_torch.testing import key_bias_lanes, noise_rule
    from bert_tpu_torch.train import make_train_step

    t_phase = time.perf_counter()
    card = gpu_line()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke")
    q4_path = os.path.join(work, "minilm_l6_q4_0.bin")
    hf_dir = os.path.join(work, "rubert_tiny2_seed0")
    f32_path = os.path.join(work, "minilm_l6_f32.bin")
    rng = np.random.default_rng(21)
    requests = [request_corpus(rng) for _ in range(SHARDED_REQUESTS)]
    hf_req = [hf_request(rng)]

    # the single-rank results on the card
    refs = {}
    for name, path, reqs in (("minilm", q4_path, requests),
                             ("rubert", hf_dir, hf_req)):
        m16 = BertTorch.from_file(path)
        refs[name] = ([m16.encode_batch(r) for r in reqs],
                      BertTorch.from_file(path, compute_dtype=torch.float32)
                      .encode_batch(reqs[0]))
        del m16
    loaded = load_model(f32_path)
    batches = train_batches(loaded, 3, 8, 64)
    opt, state = new_train_state(loaded, torch.device("cuda"), TRAIN_LR)
    step = make_train_step(loaded.config, opt)
    want_steps = []
    for b in batches:
        state, m = step(state, b)
        want_steps.append((float(m["loss"]), float(m["grad_norm"]),
                           params_to_numpy(state.params),
                           {g: {k: state.opt_state.state[p]["exp_avg"]
                                .cpu().numpy() for k, p in sub.items()}
                            for g, sub in state.params.tree().items()}))
    del opt, state
    log(f"sharded: single-rank references in "
        f"{time.perf_counter() - t_phase:.2f} s")

    mini = lambda dp, tp: {"path": q4_path, "dp": dp, "tp": tp,  # noqa
                           "requests": requests, "model": "minilm"}
    results = {}
    for world, meshes in SHARDED_MESHES.items():
        jobs = [mini(dp, tp) for dp, tp in meshes]
        train = None
        if world == 2:
            jobs.append({"path": hf_dir, "dp": 1, "tp": 2,
                         "requests": hf_req, "model": "rubert"})
        else:
            train = {"path": f32_path, "lr": TRAIN_LR, "batches": batches}
        t0 = time.perf_counter()
        ranks = spawn_ranks(world, sharded_rank, jobs, train, timeout=900)
        log(f"sharded: {world} ranks ran {len(jobs)} encode jobs"
            f"{' and 3 train steps' if train else ''} in "
            f"{time.perf_counter() - t0:.2f} s (spawn, load and run)")
        for i, job in enumerate(jobs):
            results[(job["model"], job["dp"], job["tp"])] = (
                job, [r[i] for r in ranks])
        if train:
            results["train"] = [r[len(jobs)] for r in ranks]

    summary = {}
    for key in [k for k in results if k != "train"]:
        _, ranks = results[key]
        name, dp, tp = key
        ref16, ref32 = refs[name]
        what = f"sharded {name} (dp={dp}, tp={tp})"
        d, f, h = ranks[0]["dims"]
        heads = h // tp
        for r in ranks:
            log(f"{what} rank {r['rank']} on {r['device']} "
                f"({r['backend']}): launches {r['launches']}, shapes "
                f"{r['shapes']}, buckets {r['buckets']}")
            la, sh = r["launches"], r["shapes"]
            require(la["fused_layer_norm"] > 0,
                    f"{what}: rank {r['rank']} launched no LayerNorm")
            if name == "minilm":
                want_q4 = {(d, 3 * d // tp), (d // tp, d), (d, f // tp),
                           (f // tp, d)}
                require(la["q4_matmul"] > 0 and set(sh["q4_matmul"])
                        == want_q4, f"{what}: rank {r['rank']} q4_matmul "
                        f"shapes {sh['q4_matmul']}, not {sorted(want_q4)}")
                require(la["fused_qkv_attention"] > 0
                        and sh["fused_qkv_attention"] == [heads],
                        f"{what}: rank {r['rank']} fused attention heads "
                        f"{sh['fused_qkv_attention']}, not [{heads}]")
                require(la["multi_head_attention"] == 0,
                        f"{what}: the per-(b, h) attention launched")
            else:
                require(la["multi_head_attention"] > 0
                        and sh["multi_head_attention"] == [heads],
                        f"{what}: rank {r['rank']} per-(b, h) attention "
                        f"heads {sh['multi_head_attention']}, not [{heads}]")
                require(la["q4_matmul"] == la["fused_qkv_attention"] == 0,
                        f"{what}: a kernel off the dense dh-26 path launched")
            for e, want in zip(r["embs"], ref16):
                require(e.shape == want.shape and bool(np.isfinite(e).all()),
                        f"{what}: bad embeddings {e.shape}")
            cos16 = min(float(_cos(e, w).min())
                        for e, w in zip(r["embs"], ref16))
            cos32 = float(_cos(r["e32"], ref32).min())
            err32 = float(np.abs(r["e32"] - ref32).max())
            require(all(np.array_equal(a, b) for a, b in
                        zip(r["embs"], ranks[0]["embs"])),
                    f"{what}: rank {r['rank']} got another result than "
                    "rank 0")
            require(cos16 > 0.999, f"{what}: bf16 min cos {cos16:.6f}")
            require(cos32 > 0.9999 and err32 <= 5e-3,
                    f"{what}: f32 min cos {cos32:.7f}, max|Δ| {err32:.3e}")
            dev = ("not measured" if r["device_us"] is None
                   else f"{r['device_us']:.1f} us")
            log(f"{what} rank {r['rank']}: vs the single rank, bf16 min cos "
                f"{cos16:.6f}; f32 min cos {cos32:.7f}, max|Δ| "
                f"{err32:.3e}; a request: device {dev}, wall "
                f"{r['wall_ms']:.2f} ms; load + first request "
                f"{r['load_s']:.2f} s ({ranks_label(ranks)}; {card})")
        summary[f"{name}_dp{dp}_tp{tp}"] = {
            "launches": [r["launches"] for r in ranks],
            "device_us": [r["device_us"] for r in ranks],
            "wall_ms": [r["wall_ms"] for r in ranks]}

    train = results["train"]
    label = ranks_label(results[("minilm", 2, 2)][1])
    for r in train:
        require(not any(r["launches"].values()),
                f"sharded train: kernels launched: {r['launches']}")
    got = train[0]["train"]
    noisy, keys, worst = None, key_bias_lanes(loaded.config), 0.0
    for s, (g, w) in enumerate(zip(got, want_steps), 1):
        require(all(t["train"][s - 1][0] == g[0] for t in train),
                f"sharded train: step {s} losses differ across ranks")
        loss_rel = abs(g[0] - w[0]) / abs(w[0])
        gn_rel = abs(g[1] - w[1]) / abs(w[1])
        require(np.isfinite([g[0], g[1]]).all() and loss_rel <= 1e-4
                and gn_rel <= 1e-3, f"sharded train: step {s} loss "
                f"{g[0]} vs {w[0]}, grad_norm {g[1]} vs {w[1]}")
        if noisy is None:
            noisy = {gr: {k: np.zeros(v.shape, bool) for k, v in sub.items()}
                     for gr, sub in w[2].items()}
        for gr, sub in w[2].items():
            for k, want in sub.items():
                try:
                    rr = noise_rule(g[2][gr][k], want, g[3][gr][k],
                                    w[3][gr][k], noisy[gr][k], TRAIN_LR, s,
                                    f"{gr}/{k}",
                                    exempt=keys if k == "qkv_b" else None)
                except AssertionError as e:
                    raise SmokeFailure(f"sharded train: step {s} {e}") \
                        from None
                worst = max(worst, rr["max_abs"])
        log(f"sharded train (2, 2) step {s}: loss {g[0]:.7f} / single rank "
            f"{w[0]:.7f} (rel {loss_rel:.2e}), grad_norm {g[1]:.6f} / "
            f"{w[1]:.6f} (rel {gn_rel:.2e}); rank step ms "
            f"{[round(t['train'][s - 1][4], 3) for t in train]} "
            f"({label})")
    log(f"sharded train: params max|Δ| {worst:.3e} vs the single rank after "
        f"3 steps (noise_rule held; {card})")
    summary["train"] = {"params_max_abs": worst,
                        "step_ms": [[row[4] for row in t["train"]]
                                    for t in train]}
    t_all = time.perf_counter() - t_phase
    log(f"sharded: the phase took {t_all:.2f} s")
    summary["phase_s"] = t_all
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs only on a CUDA card", file=sys.stderr)
        return 2

    import numpy as np

    from bert_tpu_torch import _kernels
    from bert_tpu_torch.ops.attention import multi_head_attention
    from bert_tpu_torch.ops.fused_attention import fused_qkv_attention
    from bert_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                int8_matmul_gelu,
                                                quantize_activations_i8)
    from bert_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                               fused_layer_norm_codes)
    from bert_tpu_torch.ops.q4_matmul import q4_matmul

    card = gpu_line()
    log(card)
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _kernels.build()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc, in parallel, into {_kernels.BUILD_DIR})")
    for name, info in _kernels.build_info.items():
        for line in info["log"].splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"  {name}: {line.strip()}")
            require("spill" not in line or re.search(
                r"(?<!\d)0 bytes spill stores, 0 bytes spill loads", line),
                f"{name}: an instance spills: {line.strip()}")

    dev = torch.device("cuda")
    # one generator per phase, so that checks added to one phase leave the
    # requests of the others as they were
    results = kernel_phase(dev, np.random.default_rng(17))
    counters = [q4_matmul, fused_layer_norm, fused_qkv_attention,
                multi_head_attention]
    launches, rate, main_split_rows, main_prof, main = main_path(
        dev, np.random.default_rng(18), counters)
    int8_counters = [int8_matmul, int8_matmul_gelu, quantize_activations_i8,
                     fused_layer_norm_codes]
    api = api_phase(main, rate, main_prof, counters + int8_counters)
    hf_launches, hf_rate, hf_split, hf_prof, hf_f32, hf_graphs = \
        hf_server_path(np.random.default_rng(19), counters)
    int8_results, int8_info = int8_path(
        dev, np.random.default_rng(20), counters + int8_counters)
    results.update(int8_results)
    train = train_path(counters + int8_counters)
    sharded = sharded_path()
    # each kernel's launches on its path: MiniLM-L6 for the first three,
    # hf_server for the per-(batch, head) attention, the bert-base int8
    # path for the int8 kernels and the LayerNorm's codes form
    launches["multi_head_attention"] = hf_launches["multi_head_attention"]
    for name in int8_results:
        launches[name] = int8_info["launches"][name]

    kernels = []
    for name in ("q4_matmul", "fused_layer_norm", "fused_qkv_attention",
                 "multi_head_attention", "int8_matmul",
                 "quantize_activations_i8", "fused_layer_norm_codes",
                 "int8_matmul_gelu"):
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "tolerance": r["tolerance"],
            "tolerance_rule": "|kernel - plain| <= tol * (1 + |plain|)",
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            **{k: v for k, v in r.items()
               if k.endswith("_ms") and k not in
               ("ms", "plain_ms", "bound_ms", "library_ms")},
            **{k: r[k] for k in ("max_abs_err_f32", "timed_shapes",
                                 "timed_shapes_f32", "shapes_f32", "router")
               if k in r},
            **({"shapes": r["shapes"], "path": "hf_server",
                "hf_server_launches": hf_launches,
                "hf_request_split": hf_split,
                "hf_server_f32_request": hf_f32} if "shapes" in r
               else {"path": "int8", "int8_path": int8_info}
               if name in int8_results else {"path": "main"}),
            **({"main_request_split": main_split_rows,
                "main_f32_request": main["f32_request"]}
               if name in ("q4_matmul", "fused_qkv_attention") else {}),
            **({"main_request_profile": main_prof,
                "hf_server_request_profile": hf_prof}
               if name == "fused_layer_norm" else {}),
        })
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.5f}")
        log(f"{name:20s} {r['shape']}: kernel {r['ms']:.5f} ms (eager "
            f"{r['eager_ms']:.5f}), plain {r['plain_ms']:.5f}, library "
            f"{lib}, bound {r['bound_ms']:.5f} ({r['bound_by']}), "
            f"{launches[name]} launches on its path")
    for name in ("q4_matmul", "fused_qkv_attention"):
        for r in results[name]["timed_shapes_f32"]:
            lib = r.get("library_ms", r.get("dense_f32_matmul_ms"))
            log(f"{name:20s} {r['shape']}: kernel {r['ms']:.5f} ms (eager "
                f"{r['eager_ms']:.5f}), plain {r['plain_ms']:.5f}, library "
                f"{lib:.5f}, bound {r['bound_ms']:.5f} ({r['bound_by']})")
    log(f"warm encode_batch: {rate:.1f} sentences/s on {card}")
    log(f"warm hf_server BATCH frames: {hf_rate:.1f} sentences/s on {card}")
    log(f"warm bert-base int8 path: {int8_info['rate']:.1f} sentences/s "
        f"(int8_eval=False: {int8_info['q4_rate']:.1f}) on {card}")
    log(f"train path (MiniLM-L6, batch 32, seq 64, f32, remat): "
        f"{train['ms_per_step']:.3f} ms/step, {train['pairs_per_s']:.1f} "
        f"pairs/s, {100 * train['f32_peak_share']:.2f}% of the f32 peak, "
        f"loss {train['loss_first']:.4f} -> {train['loss_last']:.4f} on "
        f"{card}")
    graphs = {**main["graphs"],
              "main path f32": main["f32_request"]["graphs"],
              "use_kernels=False": api["use_kernels_false"]["graphs"],
              **hf_graphs, **int8_info["graphs"]}
    log(f"graphs: {json.dumps(graphs)}")
    log(f"sharded phase: {json.dumps(sharded)}")
    log(f"API switches: {json.dumps(api)}")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

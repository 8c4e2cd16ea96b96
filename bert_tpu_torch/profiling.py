"""Tracing, timing and roofline accounting.

Counterpart of ``bert_tpu/profiling.py``:

  * :class:`PhaseTimers` — cheap host-side accumulators for the engine's
    phases (tokenize / route / dispatch / gather and their parts) and
    per-bucket execution counts, surfaced via ``BertTorch.stats()``; while
    a ``torch.profiler`` records, each phase is also a span on its
    timeline, named ``bert_tpu_torch.<phase>``;
  * :func:`trace` — a ``torch.profiler`` context over host and card
    activity that writes a Chrome / TensorBoard trace (bert_tpu's
    ``jax.profiler`` trace);
  * :func:`roofline` — bert_tpu's analytic FLOPs/bytes/speed-of-light
    accounting for an encode step, against the H100's ceilings.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict

import torch

# the prefix of a phase's span on a torch.profiler timeline
SPAN_PREFIX = "bert_tpu_torch."


def span(name: str):
    """A host span on a recording ``torch.profiler``'s timeline. It is a
    function's record, as a torch op's is, and not a user annotation
    (``record_function``'s): the profiler copies a user annotation onto
    the card's timeline, over the kernels launched inside it, where it
    would read as device time."""
    return torch._C._profiler._RecordFunctionFast(name)


# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): the
# bf16 tensor-core rate and the HBM3 rate
H100_BF16_FLOPS = 989e12
H100_HBM_BW = 3.35e12


class PhaseTimers:
    """Accumulates wall time per named phase + per-bucket execution counts.

    A part of a phase is named ``<phase>.<part>`` by its caller; a phase's
    self time is its total less its parts'. While a ``torch.profiler``
    records (and only then: entering a span costs microseconds, the check a
    fraction of one), each phase is also a span named
    ``bert_tpu_torch.<key>`` on the clock of the card's activity, so the
    card's idle gaps can be named by the phase the host was in.

    Thread-safe: unsynchronized ``+=`` on the accumulators from concurrent
    callers loses updates."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.bucket_counts: Dict[tuple, int] = defaultdict(int)
        self.sentences = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        with (span(SPAN_PREFIX + name)
              if torch._C._autograd._profiler_enabled()
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.totals[name] += dt
                    self.counts[name] += 1

    def record_bucket(self, batch: int, seq: int, kind: str = "") -> None:
        with self._lock:
            self.bucket_counts[(batch, seq, kind)] += 1

    def add_sentences(self, n: int) -> None:
        with self._lock:
            self.sentences += n

    def summary(self) -> Dict:
        with self._lock:
            return {
                "sentences": self.sentences,
                "phases": {
                    k: {"total_s": round(v, 4), "count": self.counts[k]}
                    for k, v in sorted(self.totals.items())
                },
                "buckets": {
                    f"{b}x{s}" + (f" {kind}" if kind else ""): c
                    for (b, s, kind), c in sorted(self.bucket_counts.items())
                },
            }

    def reset(self) -> None:
        """Zero every total, count, bucket count and the sentence count
        (between a benchmark's trials)."""
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.bucket_counts.clear()
            self.sentences = 0


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block's host and card activity (``torch.profiler``, CPU
    and CUDA activities where a card is present) into a Chrome trace
    ``<log_dir>/trace_<pid>.json``, viewable in Perfetto or
    chrome://tracing, and in TensorBoard's trace viewer."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


@dataclass
class RooflineEstimate:
    flops: float
    weight_bytes: float
    activation_bytes: float
    sol_compute_s: float
    sol_memory_s: float
    sol_s: float
    arithmetic_intensity: float
    notes: str = ""

    def utilization(self, measured_s: float) -> float:
        return self.sol_s / measured_s if measured_s > 0 else 0.0


def roofline(config, batch: int, seq: int, *,
             quantized: bool = True,
             act_bytes_per_el: int = 2,
             peak_flops: float = H100_BF16_FLOPS,
             peak_bw: float = H100_HBM_BW) -> RooflineEstimate:
    """Analytic cost of one encode step at (batch, seq) — bert_tpu's
    formula, with the H100's ceilings as defaults.

    FLOPs: QKV/out projections 4·D², FFN 2·D·F both ways, attention
    2·T·D per token for scores + context (×2 matmuls). Weight traffic:
    whole model once per step (small-batch regime lower bound); activation
    traffic: a few residual-stream passes (an approximation: the exact
    count depends on which ops fuse).
    """
    d, f, layers, t = (config.n_embd, config.n_intermediate,
                       config.n_layer, seq)
    tokens = batch * t
    per_token = layers * (4 * d * d + 2 * d * f) * 2  # matmul MACs → FLOPs
    attn = layers * 2 * (2 * t * d) * tokens  # scores + context
    flops = per_token * tokens + attn

    wbits = 4.5 if quantized else 16  # q4: 4b codes + scales overhead
    n_weights = layers * (4 * d * d + 2 * d * f)
    weight_bytes = (n_weights * wbits / 8
                    + config.n_vocab * d * act_bytes_per_el)
    act_bytes = tokens * d * act_bytes_per_el * layers * 6

    sol_c = flops / peak_flops
    sol_m = (weight_bytes + act_bytes) / peak_bw
    return RooflineEstimate(
        flops=flops,
        weight_bytes=weight_bytes,
        activation_bytes=act_bytes,
        sol_compute_s=sol_c,
        sol_memory_s=sol_m,
        sol_s=max(sol_c, sol_m),
        arithmetic_intensity=flops / max(weight_bytes + act_bytes, 1),
        notes="embedding-table traffic counted in weight_bytes; "
              "activation traffic approximated at 6 stream passes/layer",
    )

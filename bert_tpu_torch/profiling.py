"""Host-side phase timers.

Counterpart of ``PhaseTimers`` in ``bert_tpu/profiling.py``: cheap
accumulators for the engine's phases (tokenize / dispatch / gather) and
per-bucket execution counts, surfaced via ``BertTorch.stats()``. The
profiler wrapper and the roofline accounting are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict


class PhaseTimers:
    """Accumulates wall time per named phase + per-bucket execution counts.

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

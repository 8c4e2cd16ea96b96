"""The traced run's device trace: ``torch.profiler`` over host and card
activity, read back as device intervals and kernel times inside the
window.

The harness marks the window with a ``gpubench.window`` span and each of
its calls into the program with a ``gpubench.<what>`` span; device
activity is clipped to the window span. Idle gaps of the device are named
by the innermost host event that covers the middle of the gap (a harness
span, a torch op or a CUDA runtime call), or ``host: no recorded op``.
"""

from __future__ import annotations

import contextlib
import heapq
from collections import defaultdict
from typing import Dict, List, Optional

WINDOW = "gpubench.window"
NO_OP = "host: no recorded op"
SHORT_NS = 20_000
SHORT = "gaps under 20 us"


class DeviceTrace:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def __enter__(self) -> "DeviceTrace":
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.prof is not None:
            self.prof.__exit__(*exc)

    def span(self, name: str):
        """A host span in the trace (nothing when tracing is off)."""
        if self.prof is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def read(self) -> Optional[dict]:
        """Window length, device busy seconds, kernel seconds and launches
        by name, and the idle gaps by what the host was doing; None when
        tracing was off or no window span was recorded."""
        if self.prof is None:
            return None
        from torch.autograd import DeviceType

        host, dev = [], []
        w0 = w1 = None
        for e in self.prof.profiler.kineto_results.events():
            s, t = e.start_ns(), e.end_ns()
            if e.is_user_annotation() and e.device_type() == DeviceType.CUDA:
                continue  # a host span's shadow on the device timeline
            if e.device_type() == DeviceType.CUDA:
                dev.append((s, t, e.name()))
            elif e.name() == WINDOW:
                w0, w1 = s, t
            else:
                host.append((s, t, e.name()))
        if w0 is None:
            return None
        return summarize(w0, w1, dev, host)


def summarize(w0: int, w1: int, dev: List[tuple],
              host: List[tuple]) -> dict:
    """The window [w0, w1] (ns) of device intervals ``dev`` and host
    events ``host``, each (start, end, name)."""
    kernels: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    clipped = []
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        clipped.append((s, t))
        kernels[name] += (t - s) * 1e-9
        launches[name] += 1
    clipped.sort()
    busy, gaps, cur_s, cur_t = 0, [], None, w0
    for s, t in clipped:
        if cur_s is None or s > cur_t:
            if cur_s is not None:
                busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_s is not None:
        busy += cur_t - cur_s
    gaps.append((cur_t, w1))
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
            "kernels": dict(kernels), "launches": dict(launches),
            "idle_gaps": _name_gaps(gaps, host)}


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of idle gaps by the innermost host event (latest start)
    covering each gap's middle; gaps under SHORT_NS are summed apart."""
    by_name: Dict[str, float] = defaultdict(float)
    mids = []
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_NS:
            if g1 > g0:
                by_name[SHORT] += (g1 - g0) * 1e-9
        else:
            mids.append(((g0 + g1) // 2, (g1 - g0) * 1e-9))
    mids.sort()
    host = sorted(h for h in host if h[1] > h[0])
    active: list = []  # (-start, end, name): the latest start on top
    j = 0
    for mid, seconds in mids:
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(active, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        by_name[active[0][2] if active else NO_OP] += seconds
    return dict(by_name)


def breakdown(trace: dict) -> dict:
    """The result line's ``breakdown``: the ten device ops that took most
    time and the ten host activities that left the device idle longest."""
    top = sorted(trace["kernels"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}

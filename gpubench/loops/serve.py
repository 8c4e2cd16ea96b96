"""Online serving: ``bert_tpu_torch.server.EmbeddingServer`` in this
process (``ServerThread`` on loopback, the mix's ``server`` options), and
an open loop of text requests from a child process (gpubench/loadgen.py)
over ``connections`` persistent connections.

Arrivals are Poisson at the mix's fixed ``rate_per_s``: ``warm_s``
seconds of them for the warm-up (set-up), then the window's. Latency runs
from the time a request was due to the last byte of its reply, measured
by the client; the window's percentiles are over every request due in it,
where one never answered counts as answered at the end of the grace. Of
the window's requests, ``check.sample`` drawn from the seed and the one
with the longest text have their replies kept for the check.
"""

from __future__ import annotations

import gc
import json
import math
import os
import pickle
import socket
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

from .. import generate
from .. import run as harness
from ..registry import CHECKOUT
from ..tracing import DeviceTrace

STATS_MAGIC = b"\xb5\x87\xe3\x04"
# the warm-up's replies are all awaited before the window (a capture can
# hold a batch), for at most this long
WARM_GRACE_S = 600.0


def percentile(values: np.ndarray, q: float) -> float:
    """Nearest rank: the smallest value with at least ``q`` of the values
    at or below it."""
    s = np.sort(values)
    return float(s[max(0, math.ceil(q * len(s)) - 1)])


def stats(port: int):
    """The server's (n_served, n_batches) from a STATS frame."""
    with socket.create_connection(("127.0.0.1", port)) as s:
        _recv(s, 4)
        s.sendall(STATS_MAGIC)
        body = _recv(s, 20)
    return struct.unpack("<QQ", body[4:])


def _recv(s, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        more = s.recv(n - len(buf))
        if not more:
            raise ConnectionError("server closed")
        buf += more
    return buf


def run(cell) -> dict:
    from bert_tpu_torch.server import ServerThread

    mix = cell.mix
    trace_path = None
    if cell.trace:
        fd, trace_path = tempfile.mkstemp(prefix="gpubench-sched-",
                                          suffix=".jsonl")
        os.close(fd)
        os.environ["BERT_TPU_SCHED_TRACE"] = trace_path
    engine = harness.build_engine(cell)
    stream = generate.TextStream(mix["texts"], cell.corpus, cell.seed,
                                 cell.cap)
    arrivals = generate.rng(cell.seed, generate.ARRIVALS)
    rate = mix["rate_per_s"]
    warm_due = generate.poisson_arrivals(rate, mix["warm_s"], arrivals)
    due = generate.poisson_arrivals(rate, cell.seconds, arrivals)
    warm_texts, _ = stream.take(len(warm_due))
    texts, counts = stream.take(len(due))
    pick = generate.rng(cell.seed, generate.SAMPLE)
    keep = set(pick.choice(len(texts), size=min(len(texts),
                                                mix["check"]["sample"]),
                           replace=False).tolist())
    keep.add(int(np.argmax(counts)))
    keep = sorted(keep)

    # one call of the server's largest batch before any request: on a
    # checkout's first run it builds the kernels, which no request waits for
    engine.encode_batch(warm_texts[:mix["server"].get("max_batch", 64)])
    server = ServerThread(engine, **mix["server"]).start()
    child = subprocess.Popen(
        [sys.executable, "-m", "gpubench.loadgen"], cwd=CHECKOUT,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    ctx = {}
    try:
        pickle.dump({"port": server.port, "connections": mix["connections"],
                     "warm": (warm_texts, warm_due),
                     "window": (texts, due), "seconds": cell.seconds,
                     "grace_s": mix["grace_s"], "warm_grace_s": WARM_GRACE_S,
                     "keep": keep}, child.stdin)
        child.stdin.flush()
        warm = pickle.load(child.stdout)
        cell.notes["warm_requests"] = warm
        if warm["warm_done"] != warm["warm_due"]:
            raise RuntimeError(f"warm-up requests unanswered: {warm}")
        harness.warm_up(cell, engine, lambda c: None, [], 0, 0)
        programs = harness.n_programs(engine)
        gc.collect()
        gc.freeze()
        with DeviceTrace(cell.trace) as tr:
            if cell.trace:
                ctx["sched_stats0"] = stats(server.port)
            child.stdin.write(b"g")
            child.stdin.flush()
            t0 = pickle.load(child.stdout)["t0"]
            cell.t_window = t0
            with tr.span("gpubench.window"):
                time.sleep(max(0.0, t0 + cell.seconds - time.monotonic()))
            if cell.trace:
                ctx["sched_stats1"] = stats(server.port)
        out = pickle.load(child.stdout)
        gc.unfreeze()
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        server.stop()
    end = t0 + cell.seconds + mix["grace_s"]
    done = np.where(np.isfinite(out["done"]), out["done"], end)
    latency = done - (t0 + due)
    unanswered = int((~np.isfinite(out["done"])).sum())
    late = out["sent"] - (t0 + due)
    cell.notes.update(
        requests=len(due), offered_rate_per_s=rate,
        stray_reads=out["stray_reads"][:20],
        done_in_window=float(np.mean(out["done"] <= t0 + cell.seconds)),
        send_late_p99_ms=1e3 * percentile(np.nan_to_num(late, nan=0.0),
                                          0.99),
        captures_in_window=harness.n_programs(engine) - programs)
    if cell.trace:
        ctx["trace"] = tr.read()
        with open(trace_path, encoding="utf-8") as f:
            rows = [json.loads(line) for line in f]
        os.unlink(trace_path)
        ctx["sched_trace"] = [r for r in rows if t0 <= r.get(
            "t_first", -1) <= t0 + cell.seconds]
    peak = harness.memory_peak(cell)
    del engine, server
    harness.free(cell)
    answers = [(texts[i], out["kept"][i]) for i in keep if i in out["kept"]]
    return {"e2e": {"latency_p50_ms": 1e3 * percentile(latency, 0.50),
                    "latency_p95_ms": 1e3 * percentile(latency, 0.95)},
            "window_s": cell.seconds, "attempted": len(due),
            "failed": unanswered, "unanswered": unanswered,
            "answers": answers, "ctx": ctx, "memory_peak": peak}

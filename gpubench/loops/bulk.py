"""Bulk embedding: one caller in a closed loop of ``encode_batch`` calls of
``call_size`` texts, tokenization and the copy to the host included.

Set-up draws ``warm_calls`` calls for the warm-up and ``pool_calls`` for
the window from the one text stream, so no text repeats within a run;
should the window outrun the pool, the stream draws further calls inside
it, and the run says how many in ``notes``. The window runs whole calls
until ``--seconds`` have passed; the rate (reported under the mix's
``rate_metric``) is the texts of all its calls over its whole length. Of each call the answer to its longest text and
``check.per_call`` others drawn from the seed are kept; once the window
has closed, ``check.sample`` of them drawn from the seed, the longest
text of the window among them, go to the check.

With a ``stream`` entry (``window``, ``depth``) a call is the program's
streaming entry, ``encode_iter``, over the call's texts: the host
tokenizes and packs the next windows while the card computes earlier
ones, and the call ends once its last window is gathered. Warm-up calls
then hold ``warm_call_size`` texts.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from .. import generate
from .. import run as harness
from ..tracing import DeviceTrace


def run(cell) -> dict:
    mix = cell.mix
    engine = harness.build_engine(cell)
    stream = generate.TextStream(mix["texts"], cell.corpus, cell.seed,
                                 cell.cap)
    size = mix["call_size"]
    streamed = mix.get("stream")

    def encode(texts):
        """The call's answers, a block of rows at a time, in order."""
        if streamed is None:
            yield engine.encode_batch(texts)
        else:
            yield from engine.encode_iter(texts, **streamed)

    warm_size = mix.get("warm_call_size", size)
    warm = [stream.take(warm_size) for _ in range(mix["warm_calls"])]
    pool = [stream.take(size) for _ in range(mix["pool_calls"])]
    harness.warm_up(cell, engine, lambda c: sum(map(len, encode(c[0]))),
                    warm, mix["min_warm_calls"], mix["stable_calls"])
    programs = harness.n_programs(engine)
    pick = generate.rng(cell.seed, generate.SAMPLE)
    per_call = mix["check"]["per_call"]

    answers, kept_len, lengths = [], [], []
    n_texts = calls = drawn_in_window = 0
    ctx = {}
    call_s = []
    # what set-up made (the text pool above all) is left out of the
    # collector's passes, which would otherwise walk it inside the window
    gc.collect()
    gc.freeze()
    host0 = host_counters()
    with DeviceTrace(cell.trace) as tr:
        if cell.trace:
            ctx["stats0"] = engine.stats()
        cell.t_window = t0 = time.monotonic()
        with tr.span("gpubench.window"):
            while True:
                if calls < len(pool):
                    texts, counts = pool[calls]
                else:
                    texts, counts = stream.take(size)
                    drawn_in_window += 1
                t_call = time.monotonic()
                with tr.span("gpubench.encode_batch"):
                    start = 0
                    for out in encode(texts):
                        # of each block, its longest text and others drawn
                        part = counts[start:start + len(out)]
                        keep = [int(np.argmax(part))] + pick.integers(
                            len(out), size=per_call).tolist()
                        answers += [(texts[start + i], out[i].copy())
                                    for i in keep]
                        kept_len += [int(part[i]) for i in keep]
                        start += len(out)
                call_s.append(time.monotonic() - t_call)
                lengths.append(counts)
                n_texts += len(texts)
                calls += 1
                if time.monotonic() - t0 >= cell.seconds:
                    break
        t1 = time.monotonic()
        host1 = host_counters()
        if cell.trace:
            ctx["stats1"] = engine.stats()
    gc.unfreeze()
    if cell.trace:
        ctx["trace"] = tr.read()
        ctx["lengths"] = np.concatenate(lengths)
        ctx["act_bytes"] = engine.compute_dtype.itemsize
        from bert_tpu_torch.ops.q4_matmul import fused_max_m
        ctx["q4_fused_max_m"] = fused_max_m(engine.compute_dtype)
    cell.notes.update(calls=calls, calls_drawn_in_window=drawn_in_window,
                      call_ms_quartiles=[1e3 * q for q in np.quantile(
                          call_s, [0.25, 0.5, 0.75])],
                      captures_in_window=harness.n_programs(engine)
                      - programs,
                      host_in_window={k: host1[k] - host0[k]
                                      for k in host0})
    longest = max(range(len(answers)), key=lambda i: kept_len[i])
    chosen = set(pick.choice(len(answers), size=min(
        len(answers), mix["check"]["sample"]), replace=False).tolist())
    answers = [answers[i] for i in sorted(chosen | {longest})]
    peak = harness.memory_peak(cell)
    del engine, tr
    harness.free(cell)
    return {"e2e": {mix["rate_metric"]: n_texts / (t1 - t0)},
            "window_s": t1 - t0, "attempted": n_texts, "failed": 0,
            "unanswered": 0, "answers": answers, "ctx": ctx,
            "memory_peak": peak}


def host_counters() -> dict:
    """The CPU seconds this process (all its threads) and the calling
    thread have had: against the window's length, what the host gave."""
    return {"process_cpu_s": time.process_time(),
            "thread_cpu_s": time.thread_time()}

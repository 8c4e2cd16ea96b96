"""The port's profiling module and the server's scheduler trace, against
bert_tpu's.

``roofline`` is bert_tpu's formula with the H100's ceilings as defaults:
given the v5e peaks it must equal bert_tpu's field by field. ``trace``
writes a Chrome trace of a CPU forward. ``BERT_TPU_SCHED_TRACE`` makes
both servers' schedulers append one JSON line per dispatched batch, with
the same keys in the same order and monotonic times.

``PhaseTimers`` times phases and their parts (``<phase>.<part>``) and,
while a ``torch.profiler`` records and only then, puts each on its
timeline as a host span ``bert_tpu_torch.<key>`` that leaves no copy on
the card's timeline; a CPU engine records its host path's phases
(tokenize, route, dispatch and its parts, gather and its parts) in
``encode_batch``, ``encode_iter`` and a served text.
"""

import asyncio
import contextlib
import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from bert_tpu import profiling as jprof
from bert_tpu import server as jserver
from bert_tpu.params import BertConfig as JConfig
from bert_tpu_torch import profiling as tprof
from bert_tpu_torch import server as tserver
from bert_tpu_torch import BertTorch
from bert_tpu_torch.params import BertConfig
from test_torch_loader import write_hf_dir

CONFIGS = [dict(n_vocab=30522, n_max_tokens=512, n_embd=384,
                n_intermediate=1536, n_head=12, n_layer=6),
           dict(n_vocab=30522, n_max_tokens=512, n_embd=768,
                n_intermediate=3072, n_head=12, n_layer=12)]


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("batch,seq", [(1, 16), (64, 128), (16, 512)])
@pytest.mark.parametrize("cfg", [0, 1], ids=["minilm_l6", "bert_base"])
def test_roofline_with_v5e_peaks_is_bert_tpu_s(cfg, batch, seq, quantized):
    kw = dict(quantized=quantized, peak_flops=jprof.V5E_BF16_FLOPS,
              peak_bw=jprof.V5E_HBM_BW)
    got = tprof.roofline(BertConfig(**CONFIGS[cfg]), batch, seq, **kw)
    want = jprof.roofline(JConfig(**CONFIGS[cfg]), batch, seq, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.utilization(2 * got.sol_s) == want.utilization(2 * want.sol_s)


def test_roofline_defaults_to_the_h100():
    c = BertConfig(**CONFIGS[0])
    got = tprof.roofline(c, 8, 128)
    assert (tprof.H100_BF16_FLOPS, tprof.H100_HBM_BW) == (989e12, 3.35e12)
    assert got.sol_compute_s == got.flops / 989e12
    assert got.sol_memory_s == (got.weight_bytes
                                + got.activation_bytes) / 3.35e12
    assert not any("v5e" in name.lower() for name in vars(tprof))


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.matmul(torch.ones(64, 64), torch.ones(64, 64))
    (path,) = tmp_path.iterdir()
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


class _FakeEngine:
    """What a scheduler reads of an engine; ``eval_tokens`` sleeps a
    little, so that batches form while one runs."""

    n_max_tokens = 16

    class tokenizer:  # noqa: N801
        @staticmethod
        def tokenize_batch(texts, n):
            return [[101, len(t), 102] for t in texts]

    def eval_tokens(self, toks):
        import time

        time.sleep(0.003)
        return np.zeros((len(toks), 4), np.float32)


def _run_trace(module, path, monkeypatch):
    monkeypatch.setenv("BERT_TPU_SCHED_TRACE", str(path))

    async def go():
        sched = module.BatchingScheduler(_FakeEngine(), max_batch=4)
        sched.start()
        await asyncio.gather(*(sched.submit_tokens([101, i, 102])
                               for i in range(10)))
        await asyncio.gather(*(sched.submit(f"text {i}") for i in range(3)))
        await sched.stop()

    asyncio.run(go())
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def test_sched_trace_has_bert_tpu_s_keys(tmp_path, monkeypatch):
    got = _run_trace(tserver, tmp_path / "port.jsonl", monkeypatch)
    want = _run_trace(jserver, tmp_path / "jax.jsonl", monkeypatch)
    assert [list(r) for r in got][:1] == [list(r) for r in want][:1] == [
        ["t_first", "t_collect", "n_collect", "t_slot", "t_eval0", "t_eval1",
         "n"]]
    assert all(list(r) == list(got[0]) for r in got)
    assert sum(r["n"] for r in got) == 13
    prev = 0.0
    for r in got:
        times = [r[k] for k in ("t_first", "t_collect", "t_slot", "t_eval0",
                                "t_eval1")]
        assert times == sorted(times) and times[0] >= prev, r
        assert 1 <= r["n_collect"] <= r["n"] <= 4
        prev = r["t_first"]


def test_no_sched_trace_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("BERT_TPU_SCHED_TRACE", raising=False)
    sched = tserver.BatchingScheduler(_FakeEngine())
    assert sched._trace is None
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# PhaseTimers' nesting and its spans on the profiler's timeline
# ---------------------------------------------------------------------------

SHORT = ["going to the store", "you are welcome to come along", "Québec",
         "the time is partly cloudy outside", ""]
LONG = ["the time is partly cloudy outside " * 12,
        "you are welcome to come along " * 14]
# what a batch's host path records, on the packed and the bucketed route
ENGINE_PHASES = {"tokenize", "route", "dispatch", "dispatch.pack",
                 "dispatch.stage", "dispatch.replay", "dispatch.copy",
                 "gather", "gather.wait", "gather.place"}


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    hf = write_hf_dir(tmp_path_factory.mktemp("prof") / "hf", fmt="bin")
    eng = BertTorch.from_file(hf, device="cpu", max_batch=8)
    eng.encode_batch(SHORT + LONG)  # the programs of both routes
    return eng


def _spans(prof):
    """(name, start, end) of each of the program's spans on the host."""
    from torch.autograd import DeviceType

    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tprof.SPAN_PREFIX):
            # a host record, not a user annotation: nothing on the card's
            # timeline stands for it
            assert e.device_type() == DeviceType.CPU, e.name()
            assert not e.is_user_annotation(), e.name()
            spans.append((e.name(), e.start_ns(), e.end_ns()))
    return spans


def test_phase_parts_record_apart_and_within_their_phase():
    timers = tprof.PhaseTimers()
    with timers.phase("a"):
        with timers.phase("a.b"):
            time.sleep(0.002)
            with timers.phase("a.b.c"):
                pass
        with timers.phase("a.b"):
            pass
    with timers.phase("b"):
        pass
    tot, cnt = timers.totals, timers.counts
    assert dict(cnt) == {"a": 1, "a.b": 2, "a.b.c": 1, "b": 1}
    assert tot["a.b.c"] <= tot["a.b"] <= tot["a"]
    assert tot["a.b"] >= 0.002


def test_phases_of_concurrent_threads_all_count():
    timers = tprof.PhaseTimers()
    start = threading.Barrier(4)

    def work():
        start.wait(5)
        for _ in range(500):
            with timers.phase("a"):
                with timers.phase("a.b"):
                    pass
    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert dict(timers.counts) == {"a": 2000, "a.b": 2000}


def test_no_span_is_entered_without_a_profiler(engine, monkeypatch):
    def refuse(name):
        raise AssertionError(f"span({name!r}) entered")
    monkeypatch.setattr(tprof, "span", refuse)
    engine.timers.reset()
    engine.encode_batch(SHORT + LONG)
    assert set(engine.stats()["phases"]) == ENGINE_PHASES


def test_phases_are_spans_inside_their_parent_while_profiling():
    from torch.profiler import ProfilerActivity, profile

    timers = tprof.PhaseTimers()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.phase("a"):
            with timers.phase("a.b"):
                time.sleep(0.001)
    spans = {n: (s, t) for n, s, t in _spans(prof)}
    assert set(spans) == {"bert_tpu_torch.a", "bert_tpu_torch.a.b"}
    (a0, a1), (b0, b1) = spans["bert_tpu_torch.a"], spans["bert_tpu_torch.a.b"]
    assert a0 <= b0 < b1 <= a1 and b1 - b0 >= 1_000_000
    assert dict(timers.counts) == {"a": 1, "a.b": 1}
def test_every_engine_phase_is_a_span_while_profiling(engine):
    from torch.profiler import ProfilerActivity, profile

    engine.timers.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.encode_batch(SHORT + LONG)
    spans = _spans(prof)
    counts = {k: v["count"] for k, v in engine.stats()["phases"].items()}
    assert set(counts) == ENGINE_PHASES
    got = {}
    for name, _, _ in spans:
        assert name.startswith(tprof.SPAN_PREFIX), name
        key = name[len(tprof.SPAN_PREFIX):]
        got[key] = got.get(key, 0) + 1
    assert got == counts
    # each child lies inside a span of its parent
    by_name = {}
    for name, s, t in spans:
        by_name.setdefault(name, []).append((s, t))
    for name, intervals in by_name.items():
        parent = name.rsplit(".", 1)[0]
        if parent + "." == tprof.SPAN_PREFIX:
            continue
        for s, t in intervals:
            assert any(ps <= s and t <= pt for ps, pt in by_name[parent]), (
                name, parent)


@pytest.mark.parametrize("texts,kind", [(SHORT, "packed"), (LONG, "bucketed")])
def test_encode_batch_records_the_host_path(engine, texts, kind):
    engine.timers.reset()
    engine.encode_batch(texts)
    stats = engine.stats()
    phases = stats["phases"]
    assert set(phases) == ENGINE_PHASES
    assert all(k.endswith("packed") == (kind == "packed")
               for k in stats["buckets"])
    batches = sum(stats["buckets"].values())
    count = {k: v["count"] for k, v in phases.items()}
    # one batch: its copy, its wait; the packed batch's gather program
    # stages and replays too
    programs = 2 if kind == "packed" else 1
    assert count["dispatch.copy"] == count["gather.wait"] == batches
    assert count["dispatch.stage"] == count["dispatch.replay"] == (
        programs * batches)
    for parent in ("dispatch", "gather"):
        children = sum(v["total_s"] for k, v in phases.items()
                       if k.startswith(parent + "."))
        # totals are rounded to 0.1 ms in the summary
        assert children <= phases[parent]["total_s"] + 1e-4 * len(phases)


def test_encode_iter_records_every_window(engine):
    texts = (SHORT + LONG) * 3
    engine.timers.reset()
    blocks = list(engine.encode_iter(texts, window=4, depth=2))
    assert sum(map(len, blocks)) == len(texts)
    count = {k: v["count"] for k, v in engine.stats()["phases"].items()}
    windows = -(-len(texts) // 4)
    assert set(count) == ENGINE_PHASES
    for key in ("tokenize", "route", "dispatch", "gather"):
        assert count[key] == windows, key


def _open_phases(timers, monkeypatch):
    """The phases open at each moment on ``timers``, innermost last."""
    open_, phase = [], timers.phase

    @contextlib.contextmanager
    def tracked(name):
        with phase(name):
            open_.append(name)
            try:
                yield
            finally:
                open_.pop()
    monkeypatch.setattr(timers, "phase", tracked)
    return open_


def test_route_is_timed_outside_dispatch(engine, monkeypatch):
    import bert_tpu_torch.engine as tengine

    open_, seen = _open_phases(engine.timers, monkeypatch), {}

    def spy(fn, what):
        def wrapped(*a, **kw):
            seen.setdefault(what, list(open_))
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(tengine, "plan_packing",
                        spy(tengine.plan_packing, "plan_packing"))
    monkeypatch.setattr(tengine, "pack_batch",
                        spy(tengine.pack_batch, "pack_batch"))
    monkeypatch.setattr(tengine, "plan_buckets",
                        spy(tengine.plan_buckets, "plan_buckets"))
    engine.timers.reset()
    engine.encode_batch(SHORT + LONG)
    assert seen == {"plan_packing": ["route"],
                    "pack_batch": ["dispatch", "dispatch.pack"],
                    "plan_buckets": ["dispatch", "dispatch.pack"]}
    assert not any(k.startswith("dispatch.route")
                   for k in engine.stats()["phases"])


def test_reset_clears_the_new_phases(engine):
    engine.encode_batch(SHORT + LONG)
    assert ENGINE_PHASES <= set(engine.stats()["phases"])
    engine.timers.reset()
    stats = engine.stats()
    stats.pop("load_phases")
    assert stats == tprof.PhaseTimers().summary()


@pytest.mark.parametrize("timed", [True, False])
def test_a_program_table_times_its_calls_with_the_engine_s_timers(timed):
    from bert_tpu_torch._graphs import Programs

    timers = tprof.PhaseTimers()
    table = Programs(torch.device("cpu"), timers if timed else None)
    x = np.arange(4, dtype=np.float32)
    for k in range(3):
        prog = table.get("double", lambda x: 2 * x, {"x": x})
        np.testing.assert_array_equal(prog(x=x + k).numpy(), 2 * (x + k))
    # on the CPU nothing is captured: each call stages and runs eagerly
    assert dict(timers.counts) == (
        {"dispatch.stage": 3, "dispatch.replay": 3} if timed else {})


def test_a_served_text_counts_under_tokenize(engine):
    async def go(payloads):
        sched = tserver.BatchingScheduler(engine, max_batch=4)
        sched.start()
        try:
            return await asyncio.gather(*(
                sched.submit(p) if isinstance(p, str)
                else sched.submit_tokens(p) for p in payloads))
        finally:
            await sched.stop()

    engine.timers.reset()
    asyncio.run(go([[101, 2183, 102], [101, 102]]))
    assert "tokenize" not in engine.stats()["phases"]
    out = asyncio.run(go(["going to the store", [101, 102]]))
    phases = engine.stats()["phases"]
    assert phases["tokenize"]["count"] >= 1
    np.testing.assert_allclose(out[0], engine.encode("going to the store"),
                               atol=1e-5)

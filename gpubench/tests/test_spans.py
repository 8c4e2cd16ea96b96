"""The readers of the program's spans (``spans.py`` and the route, wait
and host-idle metrics) on synthetic contexts: what they read where the
program records its phases, and nothing where it records none."""

import pytest

from gpubench.registry import Registry

SENTENCES = ("route_us_per_sentence.bulk", "wait_us_per_sentence.bulk")
PASSAGES = ("route_us_per_passage.bulk", "wait_us_per_passage.bulk")
HOST_IDLE = ("host_idle_pct.bulk", "host_idle_pct.passages")


def _stats(sentences, phases):
    return {"sentences": sentences, "buckets": {},
            "phases": {k: {"total_s": v, "count": 1}
                       for k, v in phases.items()}}


def _trace(busy_s=9.0, window_s=10.0, gaps=None):
    return {"window_s": window_s, "busy_s": busy_s, "kernels": {},
            "launches": {}, "idle_gaps": gaps or {}}


@pytest.mark.parametrize("name", SENTENCES + PASSAGES)
def test_span_readers_read_the_phase_over_the_window(name):
    phase = "route" if name.startswith("route") else "gather.wait"
    ctx = {"stats0": _stats(1000, {phase: 0.5, "dispatch": 9.0}),
           "stats1": _stats(5000, {phase: 0.9, "dispatch": 99.0})}
    value = Registry().metric(name).read(ctx)
    assert value == pytest.approx(1e6 * 0.4 / 4000)


@pytest.mark.parametrize("name", SENTENCES + PASSAGES)
def test_span_readers_read_nothing_without_the_phase(name):
    reader = Registry().metric(name)
    # the parent's program: no route or gather.wait phase
    ctx = {"stats0": _stats(0, {"dispatch": 1.0}),
           "stats1": _stats(4000, {"dispatch": 2.0})}
    assert reader.read(ctx) is None
    assert reader.read({}) is None


@pytest.mark.parametrize("name", HOST_IDLE)
def test_host_idle_sums_only_the_program_s_spans(name):
    reader = Registry().metric(name)
    gaps = {"bert_tpu_torch.tokenize": 0.3, "bert_tpu_torch.route": 0.05,
            "bert_tpu_torch.dispatch.pack": 0.15,
            "gpubench.encode_batch": 0.2, "aten::copy_": 0.1,
            "host: no recorded op": 0.1, "gaps under 20 us": 0.1}
    ctx = {"trace": _trace(busy_s=9.0, window_s=10.0, gaps=gaps)}
    assert reader.read(ctx) == pytest.approx(100.0 * 0.5 / 10.0)


@pytest.mark.parametrize("name", HOST_IDLE)
def test_host_idle_reads_nothing_without_spans_or_a_trace(name):
    reader = Registry().metric(name)
    assert reader.read({}) is None
    assert reader.read({"trace": None}) is None
    # the parent's program: the gaps carry the harness's and torch's names
    parent = {"gpubench.encode_batch": 1.8, "aten::copy_": 0.1}
    assert reader.read({"trace": _trace(gaps=parent)}) is None
    # a CPU run: no device activity to be idle between
    cpu = {"bert_tpu_torch.tokenize": 0.4}
    assert reader.read({"trace": _trace(busy_s=0.0, gaps=cpu)}) is None


@pytest.mark.parametrize("name", HOST_IDLE)
def test_host_idle_reads_zero_where_the_spans_name_no_gap(name):
    reader = Registry().metric(name)
    # a program that records its phases, and no idle gap inside one
    ctx = {"trace": _trace(gaps={"gpubench.encode_batch": 0.01,
                                 "gaps under 20 us": 0.1}),
           "stats0": _stats(0, {"route": 0.0}),
           "stats1": _stats(4000, {"route": 0.2, "dispatch": 2.0})}
    assert reader.read(ctx) == 0.0
    # the parent's program, on the same trace: nothing to read
    ctx["stats1"] = _stats(4000, {"dispatch": 2.0})
    assert reader.read(ctx) is None

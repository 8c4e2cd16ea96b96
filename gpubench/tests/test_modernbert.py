"""The ModernBERT document cell on the CPU: a tiny ModernBERT cell through
the harness (the architecture, the mix's loop, the plain reference), the
cell's readers on a synthetic trace, and the cost model's band at the
sequences' ends."""

import copy
import json
import os
import time

import pytest
import torch

from gpubench import doc_readers, run
from gpubench.costs import attention, modernbert
from gpubench.registry import Registry, load_benchmark

from .conftest import LIMIT, write_root

CELL = "gte_modernbert_base_q4_0.doc_bulk"
TINY_CELL = "tiny_mb.docs"
SEED = 2 ** 31 + 9157
TINY = {"hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_hidden_layers": 6,
        "local_attention": 8, "max_position_embeddings": 128,
        "vocab_size": 30522}
MIX = {"loop": "bulk", "rate_metric": "passages_per_s",
       "texts": {"source": "passages", "min_tokens": 16, "max_tokens": 120},
       "call_size": 6, "warm_calls": 2, "min_warm_calls": 1,
       "stable_calls": 1, "pool_calls": 2,
       "check": {"per_call": 2, "sample": 8}}


def _bench():
    """BENCHMARK.json with the tiny ModernBERT cell in place of the card's
    cells: the document cell's metrics apply to it."""
    bench = copy.deepcopy(load_benchmark())
    bench["workloads"] = [{"name": TINY_CELL, "config": "tiny_mb",
                           "traffic": "tiny_docs", "chips": 1,
                           "why": "tiny"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [TINY_CELL] if CELL in m["workloads"] else []
    return bench


@pytest.fixture(scope="module")
def tiny_mb(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("registry_mb"))
    write_root(root)
    cfg = dict(Registry().config("gte_modernbert_base_q4_0"), **TINY,
               name="tiny_mb")
    cfg["engine"] = dict(cfg["engine"], compute_dtype="float32",
                         wire_dtype="f32")
    for kind, name, obj in (
            ("configs", "tiny_mb", cfg), ("traffic", "tiny_docs", MIX),
            ("limits", TINY_CELL,
             {"checks": {"emb_gap_max": {"limit": LIMIT},
                         "unanswered": {"limit": 0}}})):
        with open(os.path.join(root, kind, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    return _bench(), Registry(root)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_correct(tiny_mb, trace):
    bench, reg = tiny_mb
    r = run.execute(bench, TINY_CELL, SEED, 0.5, trace, "cpu", reg,
                    time.monotonic())
    assert r["correct"], r["checks"]
    assert r["notes"]["compared"] >= 3
    assert r["checks"]["emb_gap_max"]["value"] < LIMIT
    phases = r["notes"]["setup_phases_s"]["load_phases"]
    assert {"relayout", "quantize"} <= set(phases)
    if not trace:
        assert set(r["metrics"]) == {"passages_per_s", "setup_s"}


def test_tiny_cell_catches_a_planted_fault(tiny_mb):
    """Every layer made global in the program: the band's keys then
    count, and the check fails."""
    bench, reg = tiny_mb

    def hook(engine):
        engine.model.config = type(engine.model.config)(
            **dict(engine.model.config.__dict__, global_attn_every=1))
    r = run.execute(bench, TINY_CELL, SEED, 0.5, False, "cpu", reg,
                    time.monotonic(), engine_hook=hook)
    assert not r["correct"]


# -- the readers on a synthetic trace ---------------------------------------

def _ctx(attention_counts=True, launches=None):
    cfg = Registry().config("gte_modernbert_base_q4_0")
    buckets = {"8x8192": 3, "8x1024": 3}
    s1 = {"buckets": buckets, "sentences": 48}
    if attention_counts:
        s1["attention"] = {"full 8x8192": 24, "band 8x8192": 42,
                           "full 8x1024": 24, "band 8x1024": 42}
    q4 = 6 * 22 * 4
    trace = {"window_s": 2.0, "busy_s": 1.5,
             "kernels": {"q4_matmul_wgmma_kernel": 0.5,
                         "fused_attention_bf16_kernel<64>": 0.4,
                         "fused_attention_band_bf16_kernel<64>": 0.05,
                         "rope_qkv_kernel<__nv_bfloat16>": 0.02},
             "launches": {"q4_matmul_wgmma_kernel": q4,
                          "fused_attention_bf16_kernel<64>": 48,
                          "fused_attention_band_bf16_kernel<64>": 84,
                          "rope_qkv_kernel<__nv_bfloat16>": 132},
             "idle_gaps": {}}
    trace["launches"].update(launches or {})
    return {"trace": trace, "stats0": {"buckets": {}, "sentences": 0},
            "stats1": s1, "cfg": cfg, "window_s": 2.0, "act_bytes": 2,
            "q4_fused_max_m": 2 ** 31 - 1,
            "lengths": [8000, 1000] * 24}


def test_readers_on_a_synthetic_trace():
    ctx = _ctx()
    cfg = ctx["cfg"]
    full = 3 * 8 * attention.least_seconds(8, 8192, 12, 64) + \
        3 * 8 * attention.least_seconds(8, 1024, 12, 64)
    band = 3 * 14 * attention.least_seconds(8, 8192, 12, 64, 64) + \
        3 * 14 * attention.least_seconds(8, 1024, 12, 64, 64)
    assert doc_readers.attention_roofline_pct(ctx, "full") == \
        pytest.approx(100 * full / 0.4)
    assert doc_readers.attention_roofline_pct(ctx, "band") == \
        pytest.approx(100 * band / 0.05)
    flops = 24 * (modernbert.flops_per_sequence(8000, cfg)
                  + modernbert.flops_per_sequence(1000, cfg))
    assert doc_readers.mfu_pct(ctx) == pytest.approx(
        100 * flops / (2.0 * 989e12))
    q4 = doc_readers.q4_matmul_roofline_pct(ctx)
    assert q4 is not None and 0 < q4 < 100
    # a program without the attention counters (the parent) reads nothing
    assert doc_readers.attention_roofline_pct(_ctx(False), "full") is None
    # launches that differ from the counted work read nothing
    bad = _ctx(launches={"fused_attention_band_bf16_kernel<64>": 83,
                         "q4_matmul_wgmma_kernel": 1})
    assert doc_readers.attention_roofline_pct(bad, "band") is None
    assert doc_readers.q4_matmul_roofline_pct(bad) is None


def test_metric_files_read_the_readers():
    reg, ctx = Registry(), _ctx()
    for name in ("mfu_pct.docs", "q4_matmul_roofline_pct.docs",
                 "band_attention_roofline_pct.docs",
                 "full_attention_roofline_pct.docs"):
        m = reg.metric(name)
        assert (m.UNIT, m.SOURCE, m.MOVES) == ("%", "device_trace",
                                               "passages_per_s")
        assert m.read(ctx) is not None


# -- the cost model ---------------------------------------------------------

@pytest.mark.parametrize("window", [4, 64])
def test_band_pairs_at_the_sequence_ends(window):
    for t in (1, 2, window, window + 1, window + 2, 2 * window + 1, 200):
        i = torch.arange(t)
        admitted = int(((i[:, None] - i[None, :]).abs() <= window).sum())
        assert attention.pairs(t, window) == admitted, t
    assert attention.pairs(300) == 300 * 300


def test_modernbert_flops_per_token():
    cfg = Registry().config("gte_modernbert_base_q4_0")
    d, i, w = 768, 1152, 64
    for t in (5, 700):
        keys_local = sum(min(t - 1, j + w) - max(0, j - w) + 1
                         for j in range(t))
        want = t * 2 * 22 * (3 * d * d + d * d + 2 * d * i + i * d) + \
            4 * d * (8 * t * t + 14 * keys_local)
        assert modernbert.flops_per_sequence(t, cfg) == want

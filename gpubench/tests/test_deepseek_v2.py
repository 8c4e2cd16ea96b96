"""The DeepSeek-V2 passage cell on the CPU: a tiny DeepSeek-V2 cell through
the harness (the architecture's draw, model file and plain reference, the
bulk loop), the cell's readers on a synthetic trace, and the cost model.
It builds its own registry and benchmark, not ``conftest.tiny_bench``."""

import copy
import json
import os
import time

import pytest
import torch

from gpubench import fp8_control, moe_readers, run
from gpubench.costs import deepseek_v2 as cost
from gpubench.costs import q4_matmul
from gpubench.registry import Registry, load_benchmark

from .conftest import write_root

CELL = "deepseek_v2_lite_q4_0.passage_bulk"
TINY_CELL = "tiny_ds.passages"
SEED = 2 ** 31 + 9281
# the tests' tiny sizes: widths that the Q4 layout takes (K a multiple of
# 64), 2 MoE layers of 8 experts (top 2) and 1 shared
TINY = {"hidden_size": 64, "intermediate_size": 128, "kv_lora_rank": 64,
        "moe_intermediate_size": 64, "n_routed_experts": 8,
        "num_experts_per_tok": 2, "n_shared_experts": 1,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "num_hidden_layers": 3, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16,
        "max_position_embeddings": 256, "vocab_size": 30522}
MIX = {"loop": "bulk", "rate_metric": "passages_per_s",
       "texts": {"source": "passages", "min_tokens": 16, "max_tokens": 120},
       "call_size": 6, "warm_calls": 2, "min_warm_calls": 1,
       "stable_calls": 1, "pool_calls": 2,
       "check": {"per_call": 2, "sample": 8}}
# f32 on both sides over the same Q4_0 codes: the order of sums alone
LIMIT = 2e-4


def _bench():
    """BENCHMARK.json with the tiny DeepSeek-V2 cell in place of the card's
    cells: the passage cell's metrics apply to it."""
    bench = copy.deepcopy(load_benchmark())
    bench["workloads"] = [{"name": TINY_CELL, "config": "tiny_ds",
                           "traffic": "tiny_passages", "chips": 1,
                           "why": "tiny"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [TINY_CELL] if CELL in m["workloads"] else []
    return bench


@pytest.fixture(scope="module")
def tiny_ds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("registry_ds"))
    write_root(root)
    cfg = dict(Registry().config("deepseek_v2_lite_q4_0"), **TINY,
               name="tiny_ds")
    cfg["weights"] = dict(cfg["weights"], attention_std=0.08, matrix_std=0.08,
                          router_std=0.3)
    cfg["engine"] = dict(cfg["engine"], compute_dtype="float32",
                         wire_dtype="f32")
    for kind, name, obj in (
            ("configs", "tiny_ds", cfg), ("traffic", "tiny_passages", MIX),
            ("limits", TINY_CELL,
             {"checks": {"emb_gap_max": {"limit": LIMIT},
                         "unanswered": {"limit": 0}}})):
        with open(os.path.join(root, kind, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    return _bench(), Registry(root)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_correct(tiny_ds, trace):
    bench, reg = tiny_ds
    r = run.execute(bench, TINY_CELL, SEED, 0.5, trace, "cpu", reg,
                    time.monotonic())
    assert r["correct"], r["checks"]
    assert r["notes"]["compared"] >= 3
    phases = r["notes"]["setup_phases_s"]["load_phases"]
    assert {"parse", "repack", "emb_dequant"} <= set(phases)
    if not trace:
        assert set(r["metrics"]) == {"passages_per_s", "setup_s"}


def test_tiny_cell_catches_a_planted_fault(tiny_ds):
    """The routing's weights dropped in the program (every chosen expert
    at weight 1): the check fails."""
    bench, reg = tiny_ds

    def hook(engine):
        engine.model.config = type(engine.model.config)(
            **dict(engine.model.config.__dict__, routed_scaling=3.0))
    r = run.execute(bench, TINY_CELL, SEED, 0.5, False, "cpu", reg,
                    time.monotonic(), engine_hook=hook)
    assert not r["correct"]


def test_fp8_reference_is_far(tiny_ds):
    """The control: the reference with every product's operands in float8
    e4m3 is far from the f32 reference on the tiny cell's texts."""
    bench, reg = tiny_ds
    cell = run.make_cell(bench, TINY_CELL, SEED, 0.5, False, "cpu", reg,
                         time.monotonic())
    texts = cell.corpus.sentences[:6]
    f32 = run.reference_embeddings(cell, texts)
    fp8 = run.reference_embeddings(cell, texts, precision="fp8")
    gap = float(((f32 - fp8) ** 2).sum(axis=1).max() ** 0.5)
    assert gap > 20 * LIMIT, gap


def test_fp8_control_is_not_correct(tiny_ds):
    """The control through the harness's run (gpubench.fp8_control): the
    fp8 reference in the program's place reads ``correct`` false at the
    cell's limit, and the f32 reference's routing choices are counted."""
    bench, reg = tiny_ds
    r = fp8_control.control(bench, TINY_CELL, SEED, 0.5, 3, "cpu", reg)
    assert not r["correct"], r["checks"]
    assert r["checks"]["emb_gap_max"]["value"] > 20 * LIMIT
    assert r["notes"]["compared"] >= 3
    ties = r["near_ties"]
    assert ties["pairs"] > 0 and 0 <= ties["near"] <= ties["pairs"]


# -- the readers on a synthetic trace ---------------------------------------

def _ctx(counted=True, launches=None):
    cfg = Registry().config("deepseek_v2_lite_q4_0")
    buckets = {"96x512": 2, "64x256": 2}
    s1 = {"buckets": buckets, "sentences": 512}
    if counted:
        s1["attention"] = {"causal 96x512": 54, "causal 64x256": 54}
    trace = {"window_s": 2.0, "busy_s": 1.9,
             "kernels": {"q4_matmul_wgmma_kernel": 0.3,
                         "expert_matmul_kernel<true>": 0.8,
                         "expert_matmul_kernel<false>": 0.5,
                         "causal_mla_kernel": 0.05,
                         "rope_mla_kernel": 0.01},
             "launches": {"q4_matmul_wgmma_kernel": 4 * 27 * 6,
                          "expert_matmul_kernel<true>": 4 * 26,
                          "expert_matmul_kernel<false>": 4 * 26,
                          "causal_mla_kernel": 108,
                          "rope_mla_kernel": 108},
             "idle_gaps": {}}
    trace["launches"].update(launches or {})
    return {"trace": trace, "stats0": {"buckets": {}, "sentences": 0},
            "stats1": s1, "cfg": cfg, "window_s": 2.0, "act_bytes": 2,
            "q4_fused_max_m": 2 ** 31 - 1, "lengths": [400, 200] * 128}


def test_readers_on_a_synthetic_trace():
    ctx = _ctx()
    cfg = ctx["cfg"]
    least = 2 * 26 * (cost.expert_least_seconds(96 * 512, cfg)
                      + cost.expert_least_seconds(64 * 256, cfg))
    assert moe_readers.expert_matmul_roofline_pct(ctx) == \
        pytest.approx(100 * least / 1.3)
    att = 2 * 27 * (cost.attention_least_seconds(96, 512, cfg)
                    + cost.attention_least_seconds(64, 256, cfg))
    assert moe_readers.mla_attention_roofline_pct(ctx) == \
        pytest.approx(100 * att / 0.05)
    q4 = moe_readers.q4_matmul_roofline_pct(ctx)
    assert q4 is not None and 0 < q4 < 100
    assert moe_readers.mfu_pct(ctx) == pytest.approx(
        100 * cost.flops([400, 200] * 128, cfg) / (2.0 * 989e12))
    # a program without the counters (the parent) reads nothing
    assert moe_readers.mla_attention_roofline_pct(_ctx(False)) is None
    # launches that differ from the counted work read nothing
    bad = _ctx(launches={"expert_matmul_kernel<true>": 1,
                         "q4_matmul_wgmma_kernel": 1,
                         "causal_mla_kernel": 3})
    assert moe_readers.expert_matmul_roofline_pct(bad) is None
    assert moe_readers.q4_matmul_roofline_pct(bad) is None
    assert moe_readers.mla_attention_roofline_pct(bad) is None
    # a trace without the kernels (the parent's) reads nothing
    none = _ctx()
    none["trace"]["kernels"] = {}
    none["trace"]["launches"] = {}
    assert moe_readers.expert_matmul_roofline_pct(none) is None


def test_metric_files_read_the_readers():
    reg, ctx = Registry(), _ctx()
    for name in ("mfu_pct.moe", "expert_matmul_roofline_pct.moe",
                 "q4_matmul_roofline_pct.moe",
                 "mla_attention_roofline_pct.moe"):
        m = reg.metric(name)
        assert (m.UNIT, m.SOURCE, m.MOVES) == ("%", "device_trace",
                                               "passages_per_s")
        assert m.read(ctx) is not None


# -- the cost model ---------------------------------------------------------

def test_weights_a_token_touches():
    """DeepSeek-V2-Lite: about 2.24 B weights a token (by component:
    1.80 B in the experts, 0.37 B in attention, 0.07 B in layer 0)."""
    cfg = Registry().config("deepseek_v2_lite_q4_0")
    w = cost.weights_per_token(cfg)
    assert 2.20e9 < w < 2.30e9, w
    experts = 26 * 3 * 2048 * 1408 * 8
    assert experts == pytest.approx(1.80e9, rel=0.01)
    for t in (1, 7, 300):
        i = torch.arange(t)
        assert cost.pairs(t) == int((i[None, :] <= i[:, None]).sum())


def test_expert_bytes_count_every_expert_once():
    cfg = Registry().config("deepseek_v2_lite_q4_0")
    small = cost.expert_least_seconds(8, cfg)
    # at 8 tokens the products are bound by all 64 experts' weights
    weights = 64 * (2048 * 2816 + 1408 * 2048) * q4_matmul.Q4_0_BYTES_PER_WEIGHT
    assert small >= weights / 3.35e12

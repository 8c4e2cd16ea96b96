"""The harness on the CPU's plain path: the lookup by name in a registry
of its own, a dummy mix and a dummy metric added as new files, the result
line, the planted faults that ``correct`` has to catch, and the modules a
run loads."""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from gpubench import registry, run
from gpubench.registry import CHECKOUT, PKG, Registry, load_benchmark

from .conftest import LIMIT, tiny_bench, write_root

SEED = 2 ** 31 + 4242
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def test_added_mix_and_metric_run_without_editing(tmp_path):
    root = str(tmp_path)
    write_root(root)
    with open(os.path.join(root, "traffic", "dummy_mix.json"), "w") as f:
        json.dump({"loop": "bulk", "rate_metric": "sentences_per_s",
                   "texts": {"source": "sentences"},
                   "call_size": 7, "warm_calls": 1, "min_warm_calls": 1,
                   "stable_calls": 0, "pool_calls": 1,
                   "check": {"per_call": 1, "sample": 8}}, f)
    with open(os.path.join(root, "limits", "tiny.dummy.json"), "w") as f:
        json.dump({"checks": {"emb_gap_max": {"limit": LIMIT},
                              "unanswered": {"limit": 0}}}, f)
    with open(os.path.join(root, "metrics", "texts_per_call.dummy.py"),
              "w") as f:
        f.write(textwrap.dedent('''
            UNIT = "texts/call"
            SOURCE = "program_counter"
            MOVES = "sentences_per_s"

            def read(ctx):
                s0, s1 = ctx["stats0"], ctx["stats1"]
                return (s1["sentences"] - s0["sentences"]) / 1.0
            '''))
    bench = tiny_bench()
    bench["workloads"].append({"name": "tiny.dummy", "config": "tiny",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "dummy"})
    bench["per_layer"].append({"name": "texts_per_call.dummy",
                               "unit": "texts/call", "better": "higher",
                               "source": "program_counter",
                               "layer": "engine", "moves": "sentences_per_s",
                               "workloads": ["tiny.dummy"]})
    for m in bench["end_to_end"]:
        if m["name"] == "sentences_per_s":
            m["workloads"].append("tiny.dummy")
    reg = Registry(root)
    r = run.execute(bench, "tiny.dummy", SEED, 0.3, True, "cpu", reg,
                    time.monotonic())
    assert r["correct"]
    assert r["metrics"]["texts_per_call.dummy"]["value"] > 0
    r = run.execute(bench, "tiny.dummy", SEED, 0.3, False, "cpu", reg,
                    time.monotonic())
    assert set(r["metrics"]) == {"sentences_per_s", "setup_s"}


@pytest.mark.parametrize("cell,trace", [
    ("tiny.sentences", 0), ("tiny.stream", 0), ("tiny.stream", 1),
    ("tiny.passages", 1), ("tiny.queries", 0), ("tiny.queries", 1)])
def test_result_line(tiny, cell, trace):
    bench, reg = tiny
    r = run.execute(bench, cell, SEED, 0.5, bool(trace), "cpu", reg,
                    time.monotonic())
    assert all(k in r for k in KEYS) and list(r)[-1] == "checks"
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    json.dumps(r, allow_nan=False)
    w = registry.workload(bench, cell)
    if trace:
        want = {m["name"] for m in registry.metrics_for(
            bench["per_layer"], w)}
        # device readers read nothing from a CPU run
        got = set(r["metrics"])
        assert got <= want
        assert not {m for m in got if "idle" in m or "roofline" in m
                    or "mfu" in m}
        # what the program counts and times is read on the CPU too
        assert got == {m for m in want if m.split(".")[0] in (
            "sched_batch_requests", "sched_wait_ms", "batch_eval_ms",
            "dispatch_us_per_sentence", "tokenize_us_per_sentence",
            "dispatch_us_per_passage", "tokenize_us_per_passage")}
        assert got
    else:
        want = {m["name"] for m in registry.metrics_for(
            bench["end_to_end"], w)}
        assert set(r["metrics"]) == want and "setup_s" in want
        assert all(v["value"] > 0 for v in r["metrics"].values())


def _swap_rows(out):
    return np.roll(out, 1, axis=0)


def _fault_answer(engine):
    """An answer altered where it is produced: each call's, batch's or
    streamed window's rows come back rolled by one (a row reaches another
    text's caller), and a batch of one comes back with its first component
    negated."""
    eval_tokens = engine.eval_tokens
    materialize = engine._materialize_window

    def alter(out):
        if len(out) > 1:
            return np.ascontiguousarray(_swap_rows(out))
        out = out.copy()
        out[:, 0] = -out[:, 0]
        return out
    engine.eval_tokens = lambda token_lists: alter(eval_tokens(token_lists))
    engine._materialize_window = lambda item: alter(materialize(item))


def _fault_token(engine):
    """A token altered where it is produced: the tokenizer's first word of
    every text becomes another corpus word."""
    tokenize_batch = engine.tokenizer.tokenize_batch

    def faulty(texts, n_max_tokens=None):
        out = tokenize_batch(texts, n_max_tokens)
        for ids in out:
            if len(ids) > 2:
                ids[1] = 1000 + (ids[1] + 1) % 2000
        return out
    engine.tokenizer.tokenize_batch = faulty


@pytest.mark.parametrize("fault", [_fault_answer, _fault_token])
@pytest.mark.parametrize("cell", ["tiny.sentences", "tiny.stream",
                                  "tiny.queries"])
def test_planted_faults_are_not_correct(tiny, cell, fault):
    bench, reg = tiny
    r = run.execute(bench, cell, SEED, 0.5, False, "cpu", reg,
                    time.monotonic(), engine_hook=fault)
    assert not r["correct"]
    assert r["checks"]["emb_gap_max"]["value"] > 100 * LIMIT


def test_unanswered_request_is_not_correct(tiny):
    """A request whose reply never comes (the scheduler drops every
    twentieth batch's futures) fails the run."""
    bench, reg = tiny

    def drop(engine):
        eval_tokens, calls = engine.eval_tokens, [0]

        def slow(token_lists):
            calls[0] += 1
            if calls[0] % 20 == 0:
                import time as t
                t.sleep(4)
            return eval_tokens(token_lists)
        engine.eval_tokens = slow
    mix = {"grace_s": 1.0, "rate_per_s": 200}
    r = run.execute(bench, "tiny.queries", SEED, 1.0, False, "cpu", reg,
                    time.monotonic(), engine_hook=drop, mix_overrides=mix)
    assert r["failed"] > 0 and not r["correct"]
    assert r["checks"]["unanswered"]["value"] == r["failed"]


def test_a_run_loads_no_jax(tmp_path):
    """A process that imports the harness and runs one cell's code path on
    the CPU holds no module whose top-level name is jax, jaxlib, flax or
    bert_tpu."""
    root = str(tmp_path)
    write_root(root)
    code = textwrap.dedent(f'''
        import sys, time
        sys.path.insert(0, {CHECKOUT!r})
        from gpubench import run
        from gpubench.registry import Registry
        from gpubench.tests.conftest import tiny_bench
        r = run.execute(tiny_bench(), "tiny.sentences", 5, 0.2, True, "cpu",
                        Registry({root!r}), time.monotonic())
        assert r["correct"]
        print("FORBIDDEN", run.forbidden_modules())
        ''')
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "bert_tpu_torch_fake", object())
    assert "bert_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "bert_tpu.fake", object())
    assert run.forbidden_modules() == ["bert_tpu"]


def test_no_card_exits_nonzero_without_a_result():
    out = subprocess.run(
        [sys.executable, "-m", "gpubench", "--workload",
         "bert_base_q4_0.sts_stream", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=CHECKOUT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_file_names_existing_files():
    bench = load_benchmark()
    reg = Registry()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        cfg = reg.config(c["name"])
        assert os.path.join(CHECKOUT, c["file"]) == os.path.join(
            PKG, "configs", c["name"] + ".json")
        assert cfg["source"] == c["source"] and cfg["reduced"] == []
    for w in bench["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        reg.traffic(w["traffic"])
        assert set(reg.limits(w["name"])["checks"]) == {"emb_gap_max",
                                                       "unanswered"}
    for m in bench["per_layer"]:
        mod = reg.metric(m["name"])
        assert (mod.UNIT, mod.SOURCE, mod.MOVES) == (
            m["unit"], m["source"], m["moves"])

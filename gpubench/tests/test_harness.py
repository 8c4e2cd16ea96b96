"""The harness on the CPU's plain path: the lookup by name in a registry
of its own, a dummy mix, a dummy metric and a toy architecture added as
new files, the result line, the planted faults that ``correct`` has to
catch, and the modules a run loads."""

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

from .conftest import (LIMIT, bench_with, parked_cells, tiny_bench,
                       tiny_config, write_root)

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


TOY_ARCH = '''
"""A toy architecture: bert's pieces, each call noted beside this file."""

import json
import os

from gpubench.registry import Registry

HERE = os.path.dirname(os.path.abspath(__file__))
bert = Registry(os.path.dirname(HERE)).arch("bert")
FLIP = {flip}


def note(**kw):
    with open(os.path.join(HERE, "{name}.calls.jsonl"), "a") as f:
        f.write(json.dumps(kw) + "\\n")


def draw(cfg, seed, device):
    note(hook="draw", seed=seed)
    return bert.draw(cfg, seed, device)


def write(directory, cfg, vocab, weights):
    note(hook="write", n_vocab=len(vocab))
    return bert.write(directory, cfg, vocab, weights)


class Reference(bert.Reference):
    def __init__(self, weights, cfg, device, precision="f32"):
        note(hook="reference", precision=precision)
        super().__init__(weights, cfg, device, precision=precision)

    def embed(self, token_lists, **kw):
        note(hook="embed", first=sorted({{t[0] for t in token_lists}}),
             last=sorted({{t[-1] for t in token_lists}}))
        out = super().embed(token_lists, **kw)
        return -out if FLIP else out
'''
# a vocabulary of its own size, not the tiny configuration's 30,522
TOY_VOCAB = 31000


def _toy_root(root, name, flip):
    """A registry root with the architecture ``name`` (bert's pieces, noted;
    ``flip``: its reference negates every embedding) and the cell
    ``tiny.<name>``, a tiny configuration that names it, written as new
    files; the benchmark with the cell in its rate metric's workloads."""
    write_root(root)
    with open(os.path.join(root, "archs", f"{name}.py"), "w") as f:
        f.write(TOY_ARCH.format(name=name, flip=flip))
    cfg = dict(tiny_config(), name=name, architecture=name,
               vocab_size=TOY_VOCAB)
    with open(os.path.join(root, "configs", f"{name}.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "limits", f"tiny.{name}.json"), "w") as f:
        json.dump({"checks": {"emb_gap_max": {"limit": LIMIT},
                              "unanswered": {"limit": 0}}}, f)
    bench = tiny_bench()
    bench["configs"].append({"name": name, "source": "toy",
                             "file": f"gpubench/configs/{name}.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": f"tiny.{name}", "config": name,
                               "traffic": "tiny_stream", "chips": 1,
                               "why": "toy"})
    for m in bench["end_to_end"]:
        if m["name"] == "sentences_per_s":
            m["workloads"].append(f"tiny.{name}")
    return bench, Registry(root)


def _calls(root, name):
    with open(os.path.join(root, "archs", f"{name}.calls.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_added_architecture_runs_without_editing(tmp_path):
    """A configuration that names a new architecture, and that
    architecture's module, run as added files: every hook is called, and
    the configuration's vocabulary size reaches the program (through the
    model file) and the reference (through the weights' draw)."""
    root = str(tmp_path)
    bench, reg = _toy_root(root, "toy", flip=False)
    seen = {}

    def vocab(engine):
        seen["n_vocab"] = len(engine.vocab)
        seen["tokens"] = engine.tokenize("the cat")
    r = run.execute(bench, "tiny.toy", SEED, 0.3, False, "cpu", reg,
                    time.monotonic(), engine_hook=vocab)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"sentences_per_s", "setup_s"}
    calls = _calls(root, "toy")
    assert [c["hook"] for c in calls] == ["draw", "write", "draw",
                                          "reference", "embed"]
    assert calls[1]["n_vocab"] == seen["n_vocab"] == TOY_VOCAB
    assert seen["tokens"][0] == 101 and seen["tokens"][-1] == 102
    assert calls[4]["first"] == [101] and calls[4]["last"] == [102]
    assert calls[3]["precision"] == "f32"


def test_added_architecture_reference_is_the_one_used(tmp_path):
    """A toy architecture whose reference negates every embedding reads
    ``correct`` false: the cell's reference is its architecture's."""
    root = str(tmp_path)
    bench, reg = _toy_root(root, "toy_flipped", flip=True)
    r = run.execute(bench, "tiny.toy_flipped", SEED, 0.3, False, "cpu",
                    reg, time.monotonic())
    assert not r["correct"]
    assert r["checks"]["emb_gap_max"]["value"] > 1.0
    assert "embed" in [c["hook"] for c in _calls(root, "toy_flipped")]


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
        # what the program counts and times is read on the CPU too; the
        # device's readers read nothing from a CPU run
        on_cpu = {m for m in want if reg.metric(m).SOURCE in (
            "program_span", "program_counter")}
        assert set(r["metrics"]) == on_cpu and on_cpu
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
         "bert_base_q4_0.passage_bulk", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=CHECKOUT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_file_names_existing_files():
    """BENCHMARK.json, and it with each parked cell put back, names
    files that are there; every reader agrees with its entry."""
    reg = Registry()
    assert set(load_benchmark()) == {"command", "paths", "run_seconds",
                                     "configs", "workloads", "end_to_end",
                                     "per_layer"}
    assert parked_cells()
    benches = [load_benchmark()] + [bench_with(c) for c in parked_cells()]
    for bench in benches:
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
            for w in m["workloads"]:
                assert m["moves"] in {e["name"] for e in registry.metrics_for(
                    bench["end_to_end"], registry.workload(bench, w))}
    for m in load_benchmark()["per_layer"] + tiny_bench()["per_layer"]:
        mod = reg.metric(m["name"])
        assert (mod.UNIT, mod.SOURCE, mod.MOVES) == (
            m["unit"], m["source"], m["moves"])

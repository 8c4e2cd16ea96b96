"""Fixtures of the benchmark's own tests: a tiny configuration (D=64,
two layers), small mixes and a registry root of its own in a temporary
directory, run on the CPU's plain path.

    python -m pytest gpubench/tests -q               # the CPU tests
    python -m pytest gpubench/tests -q -m gpu        # on the card
"""

import copy
import json
import os
import shutil

import pytest

from gpubench.registry import PKG, load_benchmark

TINY = {"hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 2, "num_hidden_layers": 2}
MIXES = {
    "tiny_sentences": {"loop": "bulk", "rate_metric": "sentences_per_s",
                       "texts": {"source": "sentences"},
                       "call_size": 40, "warm_calls": 3,
                       "min_warm_calls": 1, "stable_calls": 1,
                       "pool_calls": 2,
                       "check": {"per_call": 2, "sample": 48}},
    "tiny_stream": {"loop": "bulk", "rate_metric": "sentences_per_s",
                    "texts": {"source": "sentences"},
                    "call_size": 40, "stream": {"window": 16, "depth": 2},
                    "warm_call_size": 16, "warm_calls": 3,
                    "min_warm_calls": 1, "stable_calls": 1,
                    "pool_calls": 2,
                    "check": {"per_call": 2, "sample": 48}},
    "tiny_passages": {"loop": "bulk", "rate_metric": "passages_per_s",
                      "texts": {"source": "passages", "min_tokens": 64,
                                "max_tokens": 512},
                      "call_size": 6, "warm_calls": 2, "min_warm_calls": 1,
                      "stable_calls": 1, "pool_calls": 2,
                      "check": {"per_call": 2, "sample": 12}},
    "tiny_queries": {"loop": "serve", "texts": {"source": "sentences"},
                     "rate_per_s": 100, "warm_s": 0.3, "connections": 8,
                     "server": {"max_batch": 16}, "grace_s": 20,
                     "check": {"sample": 24}},
}
CELLS = {"tiny.sentences": "tiny_sentences", "tiny.stream": "tiny_stream",
         "tiny.passages": "tiny_passages", "tiny.queries": "tiny_queries"}
# f32 on the CPU: the program and the reference agree to rounding
LIMIT = 1e-4


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (skips without one)")


def tiny_config(dtype="float32"):
    with open(os.path.join(PKG, "configs", "minilm_l6_q4_0.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY, name="tiny")
    cfg["engine"] = dict(cfg["engine"], compute_dtype=dtype,
                         wire_dtype="f32" if dtype == "float32" else "f16")
    return cfg


def write_root(root):
    """A registry root: the tiny configuration, the small mixes and their
    limits, and a copy of the package's metric readers and
    architectures."""
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for d in ("metrics", "archs"):
        shutil.copytree(os.path.join(PKG, d), os.path.join(root, d))
    with open(os.path.join(root, "configs", "tiny.json"), "w") as f:
        json.dump(tiny_config(), f)
    for name, mix in MIXES.items():
        with open(os.path.join(root, "traffic", f"{name}.json"), "w") as f:
            json.dump(mix, f)
    for cell in CELLS:
        with open(os.path.join(root, "limits", f"{cell}.json"), "w") as f:
            json.dump({"checks": {"emb_gap_max": {"limit": LIMIT},
                                  "unanswered": {"limit": 0}}}, f)


# the serving cells' metrics (built, not yet in BENCHMARK.json)
SERVE_E2E = [{"name": n, "unit": "ms", "better": "lower", "bound": 0.25,
              "source": "host_clock", "workloads": ["query_serve"]}
             for n in ("latency_p50_ms", "latency_p95_ms")]
SERVE_LAYERS = [
    {"name": n, "unit": u, "better": "lower", "source": s, "layer": y,
     "moves": m, "workloads": ["query_serve"]}
    for n, u, s, y, m in (
        ("sched_batch_requests.serve", "requests/batch", "program_counter",
         "server", "latency_p95_ms"),
        ("sched_wait_ms.serve", "ms", "program_span", "server",
         "latency_p95_ms"),
        ("batch_eval_ms.serve", "ms", "program_span", "engine",
         "latency_p50_ms"),
        ("device_idle_pct.serve", "%", "device_trace", "device",
         "latency_p50_ms"))]


def parked_cells():
    """The cells taken out of BENCHMARK.json whose entries ``parked/``
    keeps."""
    return sorted(n[:-len(".json")] for n in os.listdir(
        os.path.join(PKG, "parked")) if n.endswith(".json"))


def bench_with(cell):
    """BENCHMARK.json with the parked cell ``cell`` put back: its workload
    and the metrics that only it reports, as they stood."""
    bench = copy.deepcopy(load_benchmark())
    with open(os.path.join(PKG, "parked", f"{cell}.json")) as f:
        for key, entries in json.load(f).items():
            bench[key] += entries
    return bench


def tiny_bench():
    """BENCHMARK.json with the tiny cells in place of the card's, the
    parked sentence cell's metrics for the tiny sentence cells, and the
    serving metrics for the tiny serving cell."""
    bench = bench_with("bert_base_q4_0.sts_stream")
    bench["end_to_end"] += copy.deepcopy(SERVE_E2E)
    bench["per_layer"] += copy.deepcopy(SERVE_LAYERS)
    bench["workloads"] = [{"name": c, "config": "tiny", "traffic": t,
                           "chips": 1, "why": "tiny"}
                          for c, t in CELLS.items()]
    cells = {"query_serve": ["tiny.queries"],
             "bert_base_q4_0.sts_stream": ["tiny.sentences", "tiny.stream"],
             "bert_base_q4_0.passage_bulk": ["tiny.passages"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for w in m["workloads"] for c in cells[w]]
    return bench


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    from gpubench.registry import Registry

    root = str(tmp_path_factory.mktemp("registry"))
    write_root(root)
    return tiny_bench(), Registry(root)

"""The engine's compiled programs (bert_tpu_torch/_graphs.py) on the CPU.

bert_tpu compiles one program per (rows, T) shape and weight tree, and one
for the packed rows' valid-slot gather, whose index it pads to a multiple
of 256; the port keeps one program per (rows, T, kind, regime), a CUDA
graph on the card. On the CPU nothing is captured, but the same programs
stage every batch into static buffers and run their functions eagerly, so
these tests hold the staging, the keys and the counting rule that the card
runs:

(a) ``warmup`` visits bert_tpu's shapes, call for call;
(b) the program table holds the shapes ``stats()`` records, each with
    its regime, and each program's static buffers have its shape;
(c) a batch that reuses a key with fewer rows and shorter texts leaves
    nothing of the earlier batch behind (bit for bit a fresh engine);
(d) the packed gather pads its index as bert_tpu does, and the
    embeddings match ``BertTPU.encode_batch`` (1e-5, as
    test_torch_engine.py: the same f32 arithmetic in another order);
(e) a CPU engine makes no CUDA graph and launches no kernel;
(f) the launch counters' rule: the warm-up run counts, the capture does
    not, each replay counts once (fake counters, and the card's code path
    run with fake CUDA objects); every kernel wrapper the model and the
    engine call has its counter in the op layer's registry, which a
    program's replays add to by default;
(g) threads sharing one engine get the results they get alone.
"""

import contextlib
import functools
import gc
import importlib
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bert_tpu import BertTPU
from bert_tpu_torch import BertTorch, _graphs
from bert_tpu_torch.ops.common import COUNTERS, round_up
from fixture_vocab import KNOWN_TOKENS
from test_torch_engine import corpus, model_file  # noqa: F401 (fixtures)

torch.set_num_threads(1)

WORDS = sorted(w for w in KNOWN_TOKENS
               if w.isalpha() and len(w) > 1 and not w.startswith("["))


def sentences(rng, lo, hi, n):
    return [" ".join(rng.choice(WORDS, size=int(k)))
            for k in rng.integers(lo, hi, size=n)]


def forward_keys(engine):
    return {k for k in engine._programs.table if len(k) == 4}


def recorder(calls):
    def rec(self, rows, seq, kind, *args, **kw):
        calls.append((rows, seq, kind))
    return rec


# (a) -------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["grid", "sizes", "manifest"])
def test_warmup_visits_bert_tpus_shapes(model_file, monkeypatch, how):
    kw = {"max_batch": 16}
    args = {"grid": {}, "sizes": {"batch_sizes": [1, 40], "max_rows": 8},
            "manifest": {"manifest": [
                {"rows": 3, "seq": 40}, {"rows": 8, "seq": 30,
                                         "kind": "packed"},
                {"rows": 99, "seq": 512}, {"rows": 1, "seq": 16}]}}[how]
    got, want = [], []
    monkeypatch.setattr(BertTorch, "_warm_shape", recorder(got))
    monkeypatch.setattr(BertTPU, "_warm_shape", recorder(want))
    BertTorch.from_file(model_file, device="cpu", **kw).warmup(**args)
    BertTPU.from_file(model_file, **kw).warmup(**args)
    assert got == want and len(got) > 2


def test_warmup_makes_the_programs_of_its_shapes(model_file):
    eng = BertTorch.from_file(model_file, device="cpu", max_batch=16)
    eng.warmup(batch_sizes=[1, 8], max_rows=8)
    keys = set(eng._programs.table)
    buckets = eng.seq_buckets
    want = ({(b, t, "bucketed", "q4/dense") for t in buckets for b in (1, 8)}
            | {(8, 64, "packed", "q4/dense"),
               (8, 64, "packed", "q4/dense", 256)})
    assert keys == want
    assert eng.stats()["sentences"] == 0 and not eng.timers.bucket_counts


# (b) -------------------------------------------------------------------------

def test_program_keys_are_the_stats_shapes_with_their_regime(model_file,
                                                             corpus):
    eng = BertTorch.from_file(model_file, device="cpu", int8_eval=True,
                              int8_threshold=512)
    eng.encode_batch(corpus)
    fwd = forward_keys(eng)
    assert {(r, t, "packed" if k == "packed" else "")
            for r, t, k, _ in fwd} == set(eng.timers.bucket_counts)
    assert {regime for *_, regime in fwd} == {"int8", "q4/dense"}
    for r, t, kind, regime in fwd:
        assert regime == ("int8" if r * t >= 512 else "q4/dense")
        prog = eng._programs.table[(r, t, kind, regime)]
        names = ["ids", "mask"] if kind == "bucketed" else ["ids", "seg",
                                                            "pos"]
        assert sorted(prog.inputs) == sorted(names)
        assert all(tuple(x.shape) == (r, t) for x in prog.inputs.values())
        assert prog.output.shape[0] == r
    gathers = [k for k in eng._programs.table if len(k) == 5]
    assert gathers and all(k[:4] in fwd for k in gathers)
    for k in gathers:
        assert tuple(eng._programs.table[k].inputs["flat"].shape) == (k[4],)


# (c) -------------------------------------------------------------------------

def test_a_smaller_batch_on_a_used_key_leaves_nothing_behind(model_file):
    rng = np.random.default_rng(3)
    first = sentences(rng, 70, 100, 8) + sentences(rng, 8, 16, 20)
    second = sentences(rng, 64, 70, 5) + sentences(rng, 3, 6, 9)
    eng = BertTorch.from_file(model_file, device="cpu")
    eng.encode_batch(first)
    keys = set(eng._programs.table)
    fwd = forward_keys(eng)
    got = eng.encode_batch(second)
    # the second request's batches reuse the first's forward programs
    assert forward_keys(eng) == fwd and set(eng._programs.table) >= keys
    fresh = BertTorch.from_file(model_file, device="cpu")
    np.testing.assert_array_equal(got, fresh.encode_batch(second))


# (d) -------------------------------------------------------------------------

def test_packed_gather_pads_as_bert_tpu_and_matches_it(model_file,
                                                       monkeypatch):
    rng = np.random.default_rng(4)
    texts = sentences(rng, 1, 6, 300) + sentences(rng, 70, 90, 2)
    ref_engine = BertTPU.from_file(model_file, max_batch=128)
    pads = []
    jit = ref_engine._gather_segments_jit

    def spy(emb3, flat_idx):
        pads.append(int(flat_idx.shape[0]))
        return jit(emb3, flat_idx)
    monkeypatch.setattr(ref_engine, "_gather_segments_jit", spy)
    ref = ref_engine.encode_batch(texts)
    eng = BertTorch.from_file(model_file, device="cpu", max_batch=128)
    got = eng.encode_batch(texts)
    # one packed batch of the 300 short sentences
    ours = [k[4] for k in eng._programs.table if len(k) == 5]
    assert ours == pads == [max(round_up(300, 256), 256)] == [512]
    np.testing.assert_allclose(got, ref, atol=1e-5)


# (e) -------------------------------------------------------------------------

def test_a_cpu_engine_makes_no_graph_and_launches_no_kernel(model_file,
                                                            corpus,
                                                            monkeypatch):
    def no_graph(*a, **kw):
        raise AssertionError("a CUDA graph on the CPU")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    monkeypatch.setattr(torch.cuda, "graph", no_graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", no_graph)
    for c in COUNTERS:
        monkeypatch.setattr(c, "launches", 0)
    eng = BertTorch.from_file(model_file, device="cpu", int8_eval=True,
                              int8_threshold=512)
    eng.warmup(batch_sizes=[8], max_rows=8)
    eng.encode_batch(corpus)
    assert eng._programs.table
    assert all(p.graph is None for p in eng._programs.table.values())
    assert [c.launches for c in COUNTERS] == [0] * len(COUNTERS)


# (f) -------------------------------------------------------------------------

def test_capture_counted_takes_the_capture_back():
    counters = [SimpleNamespace(launches=n) for n in (5, 0, 2)]

    def run():  # what the captured function launches
        for c, n in zip(counters, (3, 1, 0)):
            c.launches += n
    run()  # the eager warm-up counts
    delta = _graphs.capture_counted(counters, run)
    assert delta == [3, 1, 0]
    assert [c.launches for c in counters] == [8, 1, 2]
    for _ in range(4):  # each replay counts once
        _graphs.add_launches(counters, delta)
    assert [c.launches for c in counters] == [20, 5, 2]


def test_capture_runs_with_the_collector_off():
    """No garbage collection inside a capture (it could free a dead graph
    there); the collector is on again after it, also when it raises."""
    seen = []
    _graphs.capture_counted([], lambda: seen.append(gc.isenabled()))
    assert seen == [False] and gc.isenabled()

    def fails():
        raise RuntimeError("capture invalidated")
    with pytest.raises(RuntimeError):
        _graphs.capture_counted([], fails)
    assert gc.isenabled()


class _FakeGraph:
    """Records the captured call and replays it with counting suspended,
    as a graph replays its kernels without running Python."""
    made = 0

    def __init__(self):
        _FakeGraph.made += 1
        self.fn = None

    def replay(self):
        self.fn(counting=False)


def _fake_cuda(monkeypatch):
    stream = SimpleNamespace(wait_stream=lambda s: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    capturing = {}

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local" and pool == "pool"
        capturing["graph"] = g
        yield
        capturing.pop("graph")
    monkeypatch.setattr(torch.cuda, "graph", graph)
    return capturing


def test_program_counts_warm_up_and_replays_not_the_capture(monkeypatch):
    capturing = _fake_cuda(monkeypatch)
    counters = [SimpleNamespace(launches=0), SimpleNamespace(launches=0)]
    seen = []

    def fn(x, counting=True):
        g = capturing.get("graph")
        if g is not None:
            g.fn = lambda counting: fn(x, counting)
        if counting:
            counters[0].launches += 2
            counters[1].launches += 1
        seen.append(float(x.sum()))
        return x * 2

    prog = _graphs.Program(fn, {"x": torch.zeros(3)}, pool="pool",
                           counters=counters)
    prog.device = torch.device("cuda")  # take the card's path
    out = prog(x=np.arange(3.0))
    # warm-up (counted) + capture (taken back) + one replay (counted)
    assert [c.launches for c in counters] == [4, 2]
    assert prog.launches == [2, 1] and _FakeGraph.made == 1
    assert seen == [3.0, 3.0, 3.0]
    prog(x=np.full(3, 2.0))
    assert [c.launches for c in counters] == [6, 3] and _FakeGraph.made == 1
    assert seen[-1] == 6.0 and out is prog.output
    with pytest.raises(ValueError, match="shape"):
        prog(x=np.zeros(4))


# the counter of each kernel wrapper the model and the engine call, and of
# q4_matmul's wgmma instance and that instance's bf16 epilogue, and of the
# grouped expert product's two forms: (module of bert_tpu_torch.ops, name)
WRAPPER_COUNTERS = [
    ("attention", "multi_head_attention"),
    ("fused_attention", "fused_qkv_attention"),
    ("fused_attention", "fused_qkv_attention.wgmma"),
    ("fused_attention", "rope_qkv"),
    ("int8_matmul", "int8_matmul"),
    ("int8_matmul", "int8_matmul_gelu"),
    ("int8_matmul", "quantize_activations_i8"),
    ("layer_norm", "fused_layer_norm"),
    ("layer_norm", "fused_layer_norm_codes"),
    ("layer_norm", "fused_add_layer_norm"),
    ("q4_matmul", "q4_matmul"),
    ("q4_matmul", "q4_matmul.wgmma"),
    ("q4_matmul", "q4_matmul.wgmma_bf16"),
    ("layer_norm", "rms_norm"),
    ("layer_norm", "add_rms_norm"),
    ("mla_attention", "rope_mla"),
    ("mla_attention", "causal_attention"),
    ("moe", "moe_route"),
    ("moe", "expert_matmul"),
    ("moe", "expert_matmul.gate_up"),
    ("moe", "expert_matmul.down"),
    ("moe", "moe_combine"),
]


@pytest.mark.parametrize("module,name", WRAPPER_COUNTERS,
                         ids=[name for _, name in WRAPPER_COUNTERS])
def test_every_wrapper_counter_is_registered_and_replayed(monkeypatch,
                                                          module, name):
    counter = functools.reduce(getattr, name.split("."),
                               importlib.import_module(
                                   f"bert_tpu_torch.ops.{module}"))
    assert counter.__name__ == name
    assert any(c is counter for c in COUNTERS)
    capturing = _fake_cuda(monkeypatch)
    monkeypatch.setattr(counter, "launches", 0)

    def fn(x, counting=True):  # one launch of the wrapper's kernel
        g = capturing.get("graph")
        if g is not None:
            g.fn = lambda counting: fn(x, counting)
        if counting:
            counter.launches += 1
        return x + 1

    # the program's counters by default: the registry
    prog = _graphs.Program(fn, {"x": torch.zeros(2)}, pool="pool")
    prog.device = torch.device("cuda")  # take the card's path
    for _ in range(3):
        prog(x=np.zeros(2))
    # the warm-up and three replays count, the capture does not
    assert counter.launches == 4


# (g) -------------------------------------------------------------------------

def test_threads_sharing_an_engine_get_their_own_results(model_file):
    rng = np.random.default_rng(5)
    requests = [sentences(rng, 3, 12, 6) + sentences(rng, 66, 80, 1)
                for _ in range(6)]
    eng = BertTorch.from_file(model_file, device="cpu")
    alone = [eng.encode_batch(r) for r in requests]
    got = [None] * len(requests)
    errors = []

    def work(i):
        try:
            for _ in range(2):
                got[i] = eng.encode_batch(requests[i])
        except Exception as exc:  # read below
            errors.append(exc)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    for a, b in zip(got, alone):
        np.testing.assert_array_equal(a, b)

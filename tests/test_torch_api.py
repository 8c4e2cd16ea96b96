"""The port's public API held to bert_tpu's, name by name and call by call.

1. Every public function, class and method defined in a module of
   ``bert_tpu`` has a counterpart of the same name in the same module of
   ``bert_tpu_torch`` whose parameters are a superset of its own, unless
   ``JAX_ONLY`` or ``RENAMED`` below names it with a reason. A rename is
   itself checked: its new name must exist in the port.
2. The calls that API gives: ``read_ggml(path, mmap=False)`` (records
   equal to the mmap reader's and to bert_tpu's, for f32, f16, q4_0 and
   q4_1, with bert_tpu's error messages); the native tokenizer's thread
   count (``n_threads``, ``BERT_TPU_TOKENIZE_THREADS``, the auto default)
   and ``build_native(force=True)``; ``BertTorch(use_kernels=...)``;
   ``Int8Tensor.shape`` / ``.n``; ``PhaseTimers.reset()``.
3. The batching and packing planners, called directly on seeded length
   lists, give bert_tpu's exact outputs.

All of it runs on the CPU; nothing here needs the card. Tolerance: none.
Every comparison is exact, since both packages compute the same numbers
in numpy, or the same torch ops in the same order.
"""

import concurrent.futures
import dataclasses
import importlib
import inspect
import logging
import os
import pkgutil

import numpy as np
import pytest
import torch

import bert_tpu
import bert_tpu_torch
from bert_tpu import batching as j_batching
from bert_tpu import native as j_native
from bert_tpu import packing as j_packing
from bert_tpu.formats import GgmlHParams, write_ggml
from bert_tpu.formats import read_ggml as j_read_ggml
from bert_tpu.ops.int8_matmul import quantize_w8 as j_quantize_w8
from bert_tpu.params import BertConfig as JConfig
from bert_tpu.params import random_named_tensors as j_random_named
from bert_tpu.profiling import PhaseTimers as JPhaseTimers
from bert_tpu_torch import BertTorch
from bert_tpu_torch import batching as t_batching
from bert_tpu_torch import model as t_model
from bert_tpu_torch import native as t_native
from bert_tpu_torch import packing as t_packing
from bert_tpu_torch.formats import read_ggml as t_read_ggml
from bert_tpu_torch.ops.common import COUNTERS
from bert_tpu_torch.ops.int8_matmul import quantize_w8 as t_quantize_w8
from bert_tpu_torch.profiling import PhaseTimers as TPhaseTimers
from test_torch_engine import corpus, model_file  # noqa: F401 (fixtures)

torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# 1. name by name
# ---------------------------------------------------------------------------

# Keys: "module" (relative to the package), "module.name" (a function or
# class), "module.Class.method", "module.function(parameter)".

# names of bert_tpu that mean something only under JAX or on a TPU
JAX_ONLY = {
    "cache": "XLA's persistent compile cache; the process's CUDA graphs "
             "(_graphs.py) and the kernel .so cache of _kernels.py stand "
             "in for it, and graphs cannot outlive a process",
    "ops.mosaic_probe": "probes what the Mosaic compiler takes on a TPU; "
                        "the CUDA kernels take every shape",
    "ops.common.f32_precision": "the precision flag of an f32 jnp.dot on "
                                "the MXU; the port turns TF32 off once",
    "ops.fused_attention.pick_group": "the Pallas kernel's rows per score "
                                      "tile",
    "ops.fused_attention.pick_head_chunk": "the Pallas kernel's heads per "
                                           "grid step",
    "ops.fused_attention.fused_attn_supported": "Mosaic's compile envelope; "
                                                "fused_route decides by "
                                                "head dim",
    "ops.fused_attention.fused_attn_table": "Mosaic's compile envelope, "
                                            "tabulated",
    "ops.fused_attention.fused_qkv_attention(group)": "Pallas tiling, "
                                                      "from pick_group",
    "ops.fused_attention.fused_qkv_attention(head_chunk)": "Pallas tiling, "
                                                           "from "
                                                           "pick_head_chunk",
    "parallel.sharding.param_pspecs": "jax PartitionSpecs; the port's "
                                      "sharding.py cuts the tree itself",
    "parallel.sharding.batch_pspec": "a jax PartitionSpec of the batch",
    "parallel.spmd.sharded_jit": "shard_map under jit; the port's ranks "
                                 "are processes (parallel/multihost.py)",
    "parallel.spmd.shard_params(pspecs)": "jax PartitionSpecs",
    "parallel.spmd.make_sharded_encode_fn(dp_axis)": "a jax mesh axis "
                                                     "name; the port's mesh "
                                                     "holds its groups",
    "parallel.mesh.make_mesh(devices)": "jax device objects; a rank's "
                                        "device follows from its rank",
}

# names of bert_tpu the port takes under another name: (the port's name,
# why). For a parameter the port's name is a parameter of the counterpart,
# or, ending in "()", a sibling function in the port's module.
_MODULES = "the nn.Module (BertModel) that holds the weights and config"
RENAMED = {
    "engine.BertTPU": ("BertTorch", "the engine, named for its framework"),
    "engine.BertTPU(use_pallas)": ("use_kernels", "the kernel switch"),
    "model.layer_norm(use_pallas)": ("use_kernels", "the kernel switch"),
    "model.dense(use_pallas)": ("use_kernels", "the kernel switch"),
    "model.embed(use_pallas)": ("use_kernels", "the kernel switch"),
    "model.embed(params_emb)": ("w", "the embeddings module's weights"),
    "model.encoder_layer(use_pallas)": ("use_kernels", "the kernel switch"),
    "model.encoder_layer(lp)": ("w", "the layer module's weights"),
    "model.encoder_layer(tp_axis)": ("tp_group", "a process group in place "
                                                 "of a mesh axis name"),
    "model.bert_forward(use_pallas)": ("use_kernels", "the kernel switch"),
    "model.bert_forward(params)": ("model", _MODULES),
    "model.bert_forward(config)": ("model", _MODULES),
    "model.bert_forward(tp_axis)": ("model", "the BertModel carries its "
                                             "tp_group"),
    "model.bert_forward_packed(use_pallas)": ("use_kernels",
                                              "the kernel switch"),
    "model.bert_forward_packed(params)": ("model", _MODULES),
    "model.bert_forward_packed(config)": ("model", _MODULES),
    "model.bert_forward_packed(tp_axis)": ("model", "the BertModel carries "
                                                    "its tp_group"),
    "parallel.spmd.make_sharded_encode_fn(use_pallas)": ("use_kernels",
                                                         "the kernel "
                                                         "switch"),
    "parallel.spmd.make_sharded_encode_fn(tp_axis)": ("mesh", "the mesh "
                                                              "holds its "
                                                              "groups"),
    "train.make_train_step(use_pallas)": ("use_kernels", "the kernel "
                                                         "switch"),
    "ops.q4_matmul.q4_matmul(use_pallas)": ("q4_matmul_plain()",
                                            "the plain version is a "
                                            "sibling, not a flag"),
    "ops.q4_matmul.q4_matmul(interpret)": ("q4_matmul_plain()",
                                           "no interpret mode in CUDA; the "
                                           "plain version is a sibling"),
    "ops.layer_norm.fused_layer_norm(use_pallas)": ("layer_norm_plain()",
                                                    "the plain version is "
                                                    "a sibling"),
    "ops.layer_norm.fused_layer_norm(interpret)": ("layer_norm_plain()",
                                                   "no interpret mode in "
                                                   "CUDA"),
    "ops.fused_attention.fused_qkv_attention(interpret)": (
        "attention_plain()", "no interpret mode in CUDA"),
    "ops.attention.multi_head_attention(use_pallas)": ("_mha_plain()",
                                                       "the plain version "
                                                       "is a sibling"),
    "ops.attention.multi_head_attention(interpret)": ("_mha_plain()",
                                                      "no interpret mode "
                                                      "in CUDA"),
    "ops.q4_matmul.q4_dequantize_jnp": ("q4_dequantize", "torch in place "
                                                         "of jnp"),
    "ops.layer_norm.layer_norm_jnp": ("layer_norm_plain", "torch in place "
                                                          "of jnp"),
    "ops.int8_matmul.int8_matmul(it)": ("w", "an Int8Weight: the codes in "
                                             "the kernel's [N, Kp] layout "
                                             "on the device"),
}


def _modules(pkg):
    return [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
        pkg.__path__, pkg.__name__ + ".")]


JAX_MODULES = [m[len("bert_tpu."):] if m != "bert_tpu" else ""
               for m in _modules(bert_tpu)]


def _defined(module):
    """The public functions and classes defined in ``module`` itself."""
    out = {}
    for name, obj in vars(module).items():
        if name.startswith("_"):
            continue
        fn = inspect.unwrap(obj) if callable(obj) else obj
        if ((inspect.isfunction(fn) or inspect.isclass(fn))
                and getattr(fn, "__module__", None) == module.__name__):
            out[name] = fn
    return out


def _params(fn):
    return list(inspect.signature(fn).parameters)


def _members(cls):
    """A class's public methods and properties (dataclass fields are
    fields, not members, whatever their default)."""
    fields = ({f.name for f in dataclasses.fields(cls)}
              if dataclasses.is_dataclass(cls) else set())
    out = {}
    for name, obj in vars(cls).items():
        if name.startswith("_") or name in fields:
            continue
        if isinstance(obj, (staticmethod, classmethod)):
            obj = obj.__func__
        if inspect.isfunction(obj) or isinstance(obj, property):
            out[name] = obj
    return out


def _gaps(rel: str, used: set) -> list:
    """What the port lacks of bert_tpu's module ``rel``, after the
    exceptions (each one it applies is added to ``used``)."""
    key = rel or "__init__"
    if rel in JAX_ONLY:
        used.add(rel)
        return []
    jmod = importlib.import_module("bert_tpu" + (f".{rel}" if rel else ""))
    try:
        tmod = importlib.import_module(
            "bert_tpu_torch" + (f".{rel}" if rel else ""))
    except ModuleNotFoundError:
        return [f"module {key}"]
    prefix = f"{rel}." if rel else ""
    gaps = []

    def check_params(where, jfn, tfn, tscope):
        tparams = set(_params(tfn))
        for p in _params(jfn):
            k = f"{where}({p})"
            if k in JAX_ONLY:
                used.add(k)
            elif k in RENAMED:
                used.add(k)
                new = RENAMED[k][0]
                ok = (hasattr(tscope, new[:-2]) if new.endswith("()")
                      else new in tparams)
                if not ok:
                    gaps.append(f"{k} renamed to {new}, which is missing")
            elif p not in tparams:
                gaps.append(f"{k}")

    for name, jobj in _defined(jmod).items():
        k = prefix + name
        if k in JAX_ONLY:
            used.add(k)
            continue
        tname = name
        if k in RENAMED:
            used.add(k)
            tname = RENAMED[k][0]
        tobj = getattr(tmod, tname, None)
        if tobj is None:
            gaps.append(k)
            continue
        check_params(k, jobj, tobj, tmod)
        if not inspect.isclass(jobj):
            continue
        if dataclasses.is_dataclass(jobj):
            tfields = ({f.name for f in dataclasses.fields(tobj)}
                       if dataclasses.is_dataclass(tobj) else set())
            gaps += [f"{k}.{f.name} (field)" for f in dataclasses.fields(jobj)
                     if f.name not in tfields]
        for mname, jm in _members(jobj).items():
            mk = f"{k}.{mname}"
            tm = inspect.getattr_static(tobj, mname, None)
            if isinstance(tm, (staticmethod, classmethod)):
                tm = tm.__func__
            if isinstance(jm, property):
                if not isinstance(tm, property):
                    gaps.append(f"{mk} (property)")
            elif not inspect.isfunction(tm):
                gaps.append(mk)
            else:
                check_params(mk, jm, tm, tobj)
    return gaps


@pytest.mark.parametrize("rel", JAX_MODULES, ids=lambda r: r or "__init__")
def test_every_public_name_has_a_counterpart(rel):
    assert _gaps(rel, set()) == []


def test_exceptions_name_real_things_of_bert_tpu():
    """Every JAX_ONLY and RENAMED key matches something of bert_tpu, so the
    lists cannot go stale; each carries a reason."""
    used = set()
    for rel in JAX_MODULES:
        _gaps(rel, used)
    assert used == set(JAX_ONLY) | set(RENAMED)
    assert all(JAX_ONLY.values())
    assert all(len(v) == 2 and all(v) for v in RENAMED.values())


def test_parity_walk_sees_the_gaps_it_guards(monkeypatch):
    """The walk reports a missing method, a missing parameter and a
    missing property: take each away from the port and look."""
    from bert_tpu_torch.formats import ggml_bin
    from bert_tpu_torch.ops import int8_matmul as t_int8
    from bert_tpu_torch.profiling import PhaseTimers

    monkeypatch.delattr(PhaseTimers, "reset")
    monkeypatch.delattr(t_int8.Int8Tensor, "shape")

    def read_ggml(path):
        raise AssertionError("never called")
    monkeypatch.setattr(ggml_bin, "read_ggml", read_ggml)
    assert _gaps("profiling", set()) == ["profiling.PhaseTimers.reset"]
    assert _gaps("ops.int8_matmul", set()) == [
        "ops.int8_matmul.Int8Tensor.shape (property)"]
    assert _gaps("formats.ggml_bin", set()) == ["formats.ggml_bin.read_ggml"
                                                "(mmap)"]


# ---------------------------------------------------------------------------
# 2a. read_ggml(path, mmap=False)
# ---------------------------------------------------------------------------

SMALL = dict(n_vocab=64, n_max_tokens=64, n_embd=64, n_intermediate=128,
             n_head=2, n_layer=1)
FTYPES = {"f32": 0, "f16": 1, "q4_0": 2, "q4_1": 3}
MODES = {"mmap": True, "stream": False}


def _tokens(n):
    toks = [f"t{i}" for i in range(n)]
    toks[5] = "Québec"  # a multi-byte token
    return toks


@pytest.fixture(scope="module")
def ggml_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ggml_api")
    cfg = JConfig(**SMALL)
    named = j_random_named(cfg, 3)
    paths = {}
    for label, ftype in FTYPES.items():
        paths[label] = str(d / f"small_{label}.bin")
        write_ggml(paths[label],
                   GgmlHParams(cfg.n_vocab, cfg.n_max_tokens, cfg.n_embd,
                               cfg.n_intermediate, cfg.n_head, cfg.n_layer,
                               ftype=ftype),
                   _tokens(cfg.n_vocab), named)
    return paths


def _assert_same_file(a, b):
    assert dataclasses.astuple(a.hparams) == dataclasses.astuple(b.hparams)
    assert a.vocab_tokens == b.vocab_tokens
    assert list(a.tensors) == list(b.tensors)
    for name, ra in a.tensors.items():
        rb = b.tensors[name]
        assert (ra.name, ra.shape, ra.ftype) == (rb.name, rb.shape, rb.ftype)
        fa, fb = ra.to_f32(), rb.to_f32()
        assert fa.dtype == fb.dtype == np.float32
        np.testing.assert_array_equal(fa, fb)
        if ra.ftype in (0, 1):
            assert ra.data.dtype == rb.data.dtype
            assert ra.qraw is None and rb.qraw is None
        else:  # the lazy q4 fields
            np.testing.assert_array_equal(np.asarray(ra.qraw),
                                          np.asarray(rb.qraw))
            np.testing.assert_array_equal(ra.codes, rb.codes)
            np.testing.assert_array_equal(ra.scales, rb.scales)
            if ra.ftype == 2:
                assert ra.mins is None and rb.mins is None
            else:
                np.testing.assert_array_equal(ra.mins, rb.mins)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ftype", FTYPES)
def test_read_ggml_modes_match_each_other_and_bert_tpu(ggml_files, ftype,
                                                       mode):
    path = ggml_files[ftype]
    got = t_read_ggml(path, mmap=MODES[mode])
    _assert_same_file(got, t_read_ggml(path))
    _assert_same_file(got, j_read_ggml(path, mmap=MODES[mode]))
    _assert_same_file(got, j_read_ggml(path))
    # the stream reader copies: no payload is a view of a file mapping
    payloads = [r.data if r.data is not None else r.qraw
                for r in got.tensors.values()]
    assert all(isinstance(p, np.memmap) == MODES[mode] for p in payloads)


def _cut(path, tmp_path, how):
    """A damaged copy of a small f32 file (64 tokens "t0".."t63" with one
    of 7 bytes at index 5, from offset 32)."""
    raw = open(path, "rb").read()
    entry = 4 + 2  # "t0".."t4": 2 bytes each, behind a 4-byte length
    damaged = {
        "bad_magic": b"\x00\x11\x22\x33" + raw[4:],
        "vocab_entry": raw[:32 + 3 * entry + 2],   # inside entry 3's length
        "vocab_token": raw[:32 + 3 * entry + 5],   # inside token 3
        "tensor": raw[:-100],                      # inside the last payload
        "partial_header": raw + b"\x01" * 7,       # EOF rule (bert.cpp:574)
    }[how]
    out = tmp_path / f"{how}.bin"
    out.write_bytes(damaged)
    return str(out)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("how", ["bad_magic", "vocab_entry", "vocab_token",
                                 "tensor"])
def test_read_ggml_damaged_files_raise_as_bert_tpu(ggml_files, tmp_path, how,
                                                   mode):
    path = _cut(ggml_files["f32"], tmp_path, how)
    with pytest.raises(ValueError) as want:
        j_read_ggml(path, mmap=MODES[mode])
    with pytest.raises(ValueError) as got:
        t_read_ggml(path, mmap=MODES[mode])
    assert str(got.value) == str(want.value)
    assert {"bad_magic": "bad magic", "vocab_entry": "truncated vocab",
            "vocab_token": "truncated vocab token 3",
            "tensor": "truncated tensor"}[how] in str(got.value)


@pytest.mark.parametrize("mode", MODES)
def test_read_ggml_trailing_partial_header_is_eof(ggml_files, tmp_path, mode):
    path = _cut(ggml_files["q4_1"], tmp_path, "partial_header")
    got = t_read_ggml(path, mmap=MODES[mode])
    _assert_same_file(got, t_read_ggml(ggml_files["q4_1"]))
    _assert_same_file(got, j_read_ggml(path, mmap=MODES[mode]))


# ---------------------------------------------------------------------------
# 2b. the native tokenizer's thread count, build_native(force=True)
# ---------------------------------------------------------------------------

# tests/test_native.py's texts: uneven splits and empty strings
TEXTS = (["the store", "", "don't go anywhere", "Québec city",
          "going going going"] * 41)[:203]
ENV = "BERT_TPU_TOKENIZE_THREADS"


@pytest.fixture(scope="module")
def natives():
    from fixture_vocab import build_fixture_vocab

    if t_native.build_native() is None:
        pytest.skip("no C++ toolchain to build csrc/libwordpiece.so")
    v = build_fixture_vocab()
    return (t_native.NativeWordPiece(v.tokens, v.cls_id, v.sep_id),
            j_native.NativeWordPiece(v.tokens, v.cls_id, v.sep_id))


@pytest.mark.parametrize("threads", [1, 2, 3, 8, "env 3", "auto"])
def test_tokenize_batch_ids_identical_at_every_thread_count(natives,
                                                            monkeypatch,
                                                            threads):
    port, ref = natives
    monkeypatch.delenv(ENV, raising=False)
    want = ref.tokenize_batch(TEXTS, 32, n_threads=1)
    if threads == "env 3":
        monkeypatch.setenv(ENV, "3")
        got = port.tokenize_batch(TEXTS, 32)
    elif threads == "auto":
        got = port.tokenize_batch(TEXTS, 32)
    else:
        got = port.tokenize_batch(TEXTS, 32, n_threads=threads)
    assert got == want
    assert got[:3] == [[101, 1996, 3573, 102], [101, 102],
                       port.tokenize("don't go anywhere", 32)]


class _Pools:
    """Counts the worker threads each tokenize_batch call asks for."""

    def __init__(self, monkeypatch):
        self.workers = []
        real = concurrent.futures.ThreadPoolExecutor
        pools = self

        class Pool(real):
            def __init__(self, max_workers=None, **kw):
                pools.workers.append(max_workers)
                super().__init__(max_workers=max_workers, **kw)
        monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", Pool)

    def used(self, call):
        """One call's result and the threads it ran on (1: no pool)."""
        self.workers.clear()
        out = call()
        return out, self.workers[0] if self.workers else 1


# (BERT_TPU_TOKENIZE_THREADS, n_threads, batch size, threads), on a host
# of 8 cores: the argument wins, then a nonzero int in the variable as it
# stands, then one thread per 512 sentences up to a thread per core; the
# result clamped to [1, n]
THREAD_CASES = [
    (None, None, 203, 1), (None, None, 1100, 2), (None, None, 5000, 8),
    (None, 3, 203, 3), (None, 500, 203, 203), (None, 0, 203, 1),
    (None, None, 0, 1), ("3", None, 203, 3), ("3", 2, 203, 2),
    ("500", None, 203, 203), ("0", None, 1100, 2), ("-2", None, 203, 1),
    ("auto", None, 5000, 8), ("2.5", None, 203, 1),
]


@pytest.mark.parametrize("env,n_threads,n,threads", THREAD_CASES)
def test_tokenize_thread_count_as_bert_tpu(natives, monkeypatch, caplog, env,
                                           n_threads, n, threads):
    port, ref = natives
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    if env is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, env)
    texts = (TEXTS * (n // len(TEXTS) + 1))[:n]
    pools = _Pools(monkeypatch)
    with caplog.at_level(logging.WARNING):
        ids, got = pools.used(lambda: port.tokenize_batch(
            texts, 16, n_threads=n_threads))
        want_ids, want = pools.used(lambda: ref.tokenize_batch(
            texts, 16, n_threads=n_threads))
    assert got == want == threads
    assert ids == want_ids and len(ids) == n
    assert port._thread_count(n, n_threads) == threads
    warned = [(r.name, r.getMessage()) for r in caplog.records]
    if env in ("auto", "2.5"):
        # a malformed value warns, as bert_tpu does, and never raises
        msg = f"{ENV} is not an int; using the auto default"
        assert warned.count(("bert_tpu_torch.native", msg)) >= 1
        assert ("bert_tpu.native", msg) in warned
    else:
        assert not warned


def test_build_native_force_runs_make(tmp_path, monkeypatch):
    """force=True runs make though the library exists; without it, make
    is not run. ``subprocess.run`` is faked: the real library stays as it
    is for the other workers that have it loaded."""
    lib = tmp_path / "libwordpiece.so"
    lib.write_bytes(b"")
    for mod in (t_native, j_native):
        calls = []
        monkeypatch.setattr(mod, "_LIB_PATH", str(lib))
        monkeypatch.setattr(mod.subprocess, "run",
                            lambda cmd, **kw: calls.append(cmd))
        assert mod.build_native() == str(lib) and calls == []
        assert mod.build_native(force=True) == str(lib)
        assert len(calls) == 1 and calls[0][:3] == ["make", "-C",
                                                    mod._CSRC]


# ---------------------------------------------------------------------------
# 2c. BertTorch(use_kernels=...)
# ---------------------------------------------------------------------------

# the kernel wrappers the model calls (each takes its plain version on a
# CPU tensor); use_kernels=False calls the plain versions directly
WRAPPERS = ("q4_matmul", "fused_layer_norm", "fused_qkv_attention",
            "multi_head_attention", "int8_matmul", "int8_matmul_gelu",
            "int8_matmul_codes", "quantize_activations_i8",
            "fused_layer_norm_codes")


def _spy_wrappers(monkeypatch):
    calls = {}
    for name in WRAPPERS:
        real = getattr(t_model, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(t_model, name, spy)
    return calls


def _embed(engine, corpus, route):
    if route == "iter":
        return np.concatenate(list(engine.encode_iter(corpus, window=7)))
    if route == "warmup":
        engine.warmup(batch_sizes=[8], max_rows=8)
        return engine.encode_batch(corpus)
    return engine.encode_batch(corpus)


@pytest.mark.parametrize("route,kw", [
    ("batch", {}), ("iter", {}), ("warmup", {}),
    ("batch", {"int8_eval": True, "int8_threshold": 0}),
    ("batch", {"int8_eval": True, "int8_threshold": 512}),
], ids=["packed+bucketed", "encode_iter", "warmup", "int8", "int8+q4"])
def test_use_kernels_false_is_the_default_bit_for_bit(model_file, corpus,
                                                      monkeypatch, route, kw):
    default = BertTorch.from_file(model_file, device="cpu", **kw)
    plain = BertTorch.from_file(model_file, device="cpu", use_kernels=False,
                                **kw)
    assert (default.use_kernels, plain.use_kernels) == (None, False)
    calls = _spy_wrappers(monkeypatch)
    for fn in COUNTERS:  # every counter the op layer registers
        monkeypatch.setattr(fn, "launches", 0)
    want = _embed(default, corpus, route)
    assert calls, "the default engine called no kernel wrapper"
    if "int8_threshold" in kw:  # 0: every batch int8; 512: the packed one
        assert calls.get("int8_matmul")
        assert bool(calls.get("q4_matmul")) == (kw["int8_threshold"] > 0)
    calls.clear()
    got = _embed(plain, corpus, route)
    assert calls == {}, f"use_kernels=False called wrappers: {calls}"
    assert [fn.launches for fn in COUNTERS] == [0] * len(COUNTERS)
    np.testing.assert_array_equal(got, want)
    buckets = plain.stats()["buckets"]
    assert any(k.endswith("packed") for k in buckets)
    assert any(not k.endswith("packed") for k in buckets)


def test_use_kernels_true_on_the_cpu_raises_before_the_file_is_read(
        model_file, tmp_path, monkeypatch):
    msg = "use_kernels=True needs CUDA tensors, got cpu"
    with pytest.raises(ValueError, match=msg):  # a path that is no file
        BertTorch.from_file(str(tmp_path / "missing.bin"), device="cpu",
                            use_kernels=True)

    def no_load(*a, **kw):
        raise AssertionError("the file was read")
    monkeypatch.setattr("bert_tpu_torch.engine.load_model", no_load)
    with pytest.raises(ValueError, match=msg):
        BertTorch.from_file(model_file, device="cpu", use_kernels=True)
    monkeypatch.undo()
    # the model's own check (model._plain) says the same
    with pytest.raises(ValueError, match=msg):
        t_model._plain(True, torch.zeros(1))
    from bert_tpu_torch.loader import load_model
    with pytest.raises(ValueError, match=msg):
        BertTorch(load_model(model_file), device="cpu", use_kernels=True)


# ---------------------------------------------------------------------------
# 2d. Int8Tensor.shape / .n, PhaseTimers.reset()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 5), (37, 200), (3, 64, 96)])
def test_int8_tensor_shape_and_n_as_bert_tpu(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got, want = t_quantize_w8(w), j_quantize_w8(w)
    assert got.shape == want.shape == tuple(shape[-2:])
    assert got.n == want.n == shape[-1]
    np.testing.assert_array_equal(got.w_i8, want.w_i8)


def _fill(timers):
    with timers.phase("tokenize"):
        pass
    with timers.phase("tokenize"):
        pass
    timers.record_bucket(8, 128)
    timers.record_bucket(16, 64, kind="packed")
    timers.add_sentences(55)


def test_phase_timers_reset_as_bert_tpu(model_file, corpus):
    empty = TPhaseTimers().summary()
    assert empty == JPhaseTimers().summary()
    got, want = TPhaseTimers(), JPhaseTimers()
    _fill(got)
    _fill(want)
    sg, sw = got.summary(), want.summary()
    assert (sg["sentences"], sg["buckets"]) == (sw["sentences"],
                                                sw["buckets"]) != (0, {})
    assert sg["phases"]["tokenize"]["count"] == 2
    got.reset()
    want.reset()
    assert got.summary() == want.summary() == empty
    # the engine's: stats() then reports nothing but the load phases
    engine = BertTorch.from_file(model_file, device="cpu")
    engine.encode_batch(corpus[:3])
    assert engine.stats()["sentences"] == 3
    engine.timers.reset()
    stats = engine.stats()
    assert stats.pop("load_phases") and stats == empty


# ---------------------------------------------------------------------------
# 3. batching and packing, called directly
# ---------------------------------------------------------------------------

N_MAX = 512


def _length_lists():
    rng = np.random.default_rng(0)
    lists = {"empty": [], "one": [9], "all_1": [1] * 100,
             "all_n_max": [N_MAX] * 130,
             "mixed_300": rng.integers(1, N_MAX + 1, 300).tolist()}
    for n in (1, 7, 64, 65, 129, 500, 2000):
        lists[f"sentences_{n}"] = rng.integers(1, N_MAX + 1, n).tolist()
    # the shape of real text: most short, a tail of long ones
    lists["short_heavy_1000"] = np.minimum(
        rng.geometric(1 / 24, 1000) + 2, N_MAX).tolist()
    return lists


LENGTHS = _length_lists()


@pytest.mark.parametrize("minimum", [1, 2, 4, 8, 16])
def test_size_bucket_as_bert_tpu(minimum):
    for n in range(0, 2100):
        assert (t_batching.size_bucket(n, minimum)
                == j_batching.size_bucket(n, minimum)), n


def test_seq_buckets_as_bert_tpu():
    for n_max in (1, 16, 17, 64, 100, 128, 300, 512, 2048, 8192):
        buckets = t_batching.default_seq_buckets(n_max)
        assert buckets == j_batching.default_seq_buckets(n_max)
        for n in range(0, n_max + 3):
            assert (t_batching.pick_bucket(n, buckets)
                    == j_batching.pick_bucket(n, buckets))


@pytest.mark.parametrize("max_batch", [8, 64, 128])
def test_plan_batch_sizes_as_bert_tpu(max_batch):
    for min_batch in (1, 2, 4, 8):
        for n in range(0, 700):
            got = t_batching.plan_batch_sizes(n, max_batch, min_batch)
            assert got == j_batching.plan_batch_sizes(n, max_batch,
                                                      min_batch)
            assert sum(got) >= n


@pytest.mark.parametrize("name", LENGTHS)
def test_plan_buckets_as_bert_tpu(name):
    lengths = LENGTHS[name]
    for seq_buckets in (t_batching.default_seq_buckets(N_MAX),
                        [32, 128, N_MAX]):
        for max_batch, min_batch in ((128, 1), (128, 2), (64, 8), (8, 1)):
            got = t_batching.plan_buckets(lengths, seq_buckets, max_batch,
                                          min_batch)
            want = j_batching.plan_buckets(lengths, seq_buckets, max_batch,
                                           min_batch)
            assert got.groups == want.groups
            placed = sorted(i for _, _, idxs in got.groups for i in idxs)
            assert placed == list(range(len(lengths)))


def _plans(name, seq_len, max_segments):
    lengths = [min(n, seq_len) for n in LENGTHS[name]]
    return (lengths, t_packing.plan_packing(lengths, seq_len, max_segments),
            j_packing.plan_packing(lengths, seq_len, max_segments))


@pytest.mark.parametrize("name", LENGTHS)
def test_plan_packing_and_pack_batch_as_bert_tpu(name):
    rng = np.random.default_rng(1)
    for seq_len, max_segments in ((64, 16), (64, 4), (128, 16)):
        lengths, got, want = _plans(name, seq_len, max_segments)
        assert ([dataclasses.astuple(p) for p in got.placements]
                == [dataclasses.astuple(p) for p in want.placements])
        assert ((got.n_rows, got.seq_len, got.max_segments, got.occupancy)
                == (want.n_rows, want.seq_len, want.max_segments,
                    want.occupancy))
        tokens = [rng.integers(0, 30522, n).tolist() for n in lengths]
        for n_rows in (got.n_rows, got.n_rows + 3):
            for a, b in zip(t_packing.pack_batch(tokens, got, n_rows=n_rows),
                            j_packing.pack_batch(tokens, want,
                                                 n_rows=n_rows)):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_plan_packing_refuses_a_long_sentence_as_bert_tpu():
    with pytest.raises(ValueError) as want:
        j_packing.plan_packing([3, 65], 64, 16)
    with pytest.raises(ValueError) as got:
        t_packing.plan_packing([3, 65], 64, 16)
    assert str(got.value) == str(want.value)

"""Comparison rules shared by the port's tests and its card check, the
jobs its sharded tests run on each rank, and the f32 kernels' split
arithmetic written out in PyTorch.

:func:`noise_rule` holds the parameters of two AdamW runs of the same
steps (two devices, two packages, or two meshes) to each other. The
port's CPU tests hold it against bert_tpu's steps; ``chip_smoke.py``
holds the card against the CPU and the sharded steps against one rank.
:func:`rank_jobs` runs on ranks spawned by
``parallel.multihost.spawn_ranks``. :func:`split_bf16x3` and
:func:`matmul_bf16x6` are what the f32 instances of ``csrc/q4_matmul.cu``
and ``csrc/fused_attention.cu`` compute on the tensor cores, for the CPU
tests to hold against bert_tpu's HIGHEST-precision f32; nothing on the
main path calls them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np

from .params import BertConfig

NOISE_REL = 1e-3   # first moments further apart than this, relative: noise
TIGHT_ABS = 1e-6   # what every other element is held to
MAX_NOISE_SHARE = 1e-4  # of a leaf's elements that may be noise


def key_bias_lanes(config: BertConfig) -> np.ndarray:
    """[3·D] bool: the key lanes of the head-interleaved ``qkv_b`` (each
    head's [q | k | v] block of 3·d_head). Their gradient is zero in exact
    arithmetic, since softmax ignores a constant added to every key's
    score of a query, so in floating point it is rounding noise."""
    dh = config.d_head
    return (np.arange(3 * config.n_embd) // dh) % 3 == 1


def noise_rule(got: np.ndarray, want: np.ndarray, mu_got: np.ndarray,
               mu_want: np.ndarray, noisy: np.ndarray, lr: float,
               steps: int, what: str, *,
               exempt: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Hold one leaf's parameters ``got`` to ``want`` after ``steps``
    AdamW steps of two runs.

    Adam's step lr·m̂/(√v̂ + ε) is ≈ lr·sign(g) wherever |g| ≫ ε, so an
    element whose gradient is rounding noise may step either way, up to
    2·lr a step apart. Such an element is one whose first moments in the
    two runs differ by more than ``NOISE_REL`` of it at any step so far
    (``noisy`` accumulates them in place). An element whose gradient is
    zero in both runs has equal moments, so it is not noise: it moves by
    weight decay alone and is held with the rest.

    - every element: |Δ| ≤ 2·lr·steps;
    - ``exempt`` (a mask broadcast over the leaf: lanes whose gradient is
      zero in exact arithmetic, :func:`key_bias_lanes`): nothing more, and
      not counted;
    - every other element: |Δ| ≤ ``TIGHT_ABS`` (a first moment that agrees
      to ``NOISE_REL`` moves Adam's step by about lr·``NOISE_REL``),
      except noisy ones, and of those at most ``MAX_NOISE_SHARE`` of the
      leaf.

    Raises AssertionError naming ``what``; returns the leaf's size, its
    counts of noisy, exempt and beyond-``TIGHT_ABS`` elements (the last
    not exempt), and its largest differences."""
    noisy |= np.abs(mu_got - mu_want) > NOISE_REL * np.abs(mu_want)
    ex = (np.zeros(got.shape, bool) if exempt is None
          else np.broadcast_to(exempt, got.shape))
    d = np.abs(got - want)
    beyond = (d > TIGHT_ABS) & ~ex
    tight = d[~(noisy | ex)]
    out_max = float(tight.max()) if tight.size else 0.0
    n_beyond = int(beyond.sum())
    for ok, msg in (
            (float(d.max()) <= 2 * lr * steps,
             f"max|Δ| {d.max():.3e} > 2·lr·{steps}"),
            (out_max <= TIGHT_ABS,
             f"max|Δ| {out_max:.3e} where the gradient is not noise"),
            (n_beyond <= MAX_NOISE_SHARE * d.size,
             f"{n_beyond} of {d.size} elements beyond {TIGHT_ABS} (noise: "
             f"at most {MAX_NOISE_SHARE} of the leaf)")):
        if not ok:
            raise AssertionError(f"{what}: {msg}")
    return {"size": int(d.size), "noise": int((noisy & ~ex).sum()),
            "exempt": int(ex.sum()), "beyond": n_beyond,
            "max_abs": float(d.max()), "max_abs_outside_noise": out_max,
            "max_abs_exempt": float(d[ex].max()) if ex.any() else 0.0}


# --- the split arithmetic of the f32 kernels ---------------------------------

# The products of matmul_bf16x6, in the kernels' order (smallest first):
# (part of a, part of b), 0 = hi, 1 = mid, 2 = lo (csrc/hopper.cuh x6_a/b).
BF16X6_PASSES = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def split_bf16x3(x):
    """f32 tensor → (hi, mid, lo), bf16 tensors with hi + mid + lo == x
    exactly: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
    each rounded to nearest even (the kernels' ``split_bf16x3``)."""
    import torch

    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    r = x - hi.to(torch.float32)  # exact in f32
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def matmul_bf16x6(a, b, passes=BF16X6_PASSES):
    """``a @ b`` for f32 operands as the f32 kernels take it on the bf16
    tensor cores: both split three ways, each pass a bf16 × bf16 product
    taken in f32 (exact products, f32 sums), the passes summed in f32 in
    the kernels' order. ``passes`` may name fewer (a test's three-product
    variant)."""
    import torch

    sa, sb = split_bf16x3(a), split_bf16x3(b)
    out = None
    for i, j in passes:
        term = torch.matmul(sa[i].to(torch.float32), sb[j].to(torch.float32))
        out = term if out is None else out + term
    return out


# --- rank jobs --------------------------------------------------------------
# What the port's sharded tests run on each spawned rank
# (parallel.multihost.spawn_ranks(world, rank_jobs, jobs)). They live in the
# package so that spawn imports them without the test module, which
# imports JAX: a rank must not.

def _encode_job(config, params_by_name, dp, tp, poolings, ids, mask,
                compute_dtype="float32"):
    """{(name, pooling): [B, D]} from make_sharded_encode_fn on a (dp, tp)
    CPU mesh, for each host tree of ``params_by_name``."""
    import torch

    from .parallel.mesh import make_mesh
    from .parallel.spmd import make_sharded_encode_fn, shard_params

    mesh = make_mesh(dp * tp, tp=tp, device_type="cpu")
    dtype = getattr(torch, compute_dtype)
    out = {}
    for name, host in params_by_name.items():
        shard = shard_params(mesh, host)
        for pooling in poolings:
            fn = make_sharded_encode_fn(mesh, config, compute_dtype=dtype,
                                        pooling=pooling,
                                        params_example=host)
            out[(name, pooling)] = fn(shard, ids, mask).float().numpy()
    return out


@contextlib.contextmanager
def int8_codes_recorded():
    """Within the block, the engine's forwards and the int8 regime's
    activation codes (its plain path, the CPU's) are appended to the
    yielded list in the order they run: ``("batch", ids, seg)`` for each
    forward, this rank's rows [B, T] and the packed segment ids (0 on
    padding; for a bucketed batch, its mask), then ``("codes", x,
    codes)`` for each quantization in it, x [M, K] f32 and its codes
    [M, K], rows in ids' order."""
    from . import engine
    from .ops import int8_matmul as i8

    events = []
    quantize = i8.quantize_activations_i8_plain
    forward, packed = engine.bert_forward, engine.bert_forward_packed

    def quantize_recorded(x):
        codes, sx = quantize(x)
        events.append(("codes", x.float().numpy().copy(),
                       codes[:, :x.shape[1]].numpy().copy()))
        return codes, sx

    def forward_recorded(model, ids, mask, **kw):
        events.append(("batch", ids.numpy().copy(), mask.numpy().copy()))
        return forward(model, ids, mask, **kw)

    def packed_recorded(model, ids, seg, pos, **kw):
        events.append(("batch", ids.numpy().copy(), seg.numpy().copy()))
        return packed(model, ids, seg, pos, **kw)

    i8.quantize_activations_i8_plain = quantize_recorded
    engine.bert_forward = forward_recorded
    engine.bert_forward_packed = packed_recorded
    try:
        yield events
    finally:
        i8.quantize_activations_i8_plain = quantize
        engine.bert_forward, engine.bert_forward_packed = forward, packed


def _engine_job(loaded, dp, tp, token_lists, engine_kw, record=False):
    """(embeddings, bucket counts) of BertTorch(dp=, tp=) on the CPU, and
    with ``record`` this rank's :func:`int8_codes_recorded` events."""
    from .engine import BertTorch

    eng = BertTorch(loaded, device="cpu", dp=dp, tp=tp, **engine_kw)
    assert (eng._dp, eng._tp) == (dp, tp)
    if not record:
        return eng.eval_tokens(token_lists), eng.stats()["buckets"]
    with int8_codes_recorded() as events:
        emb = eng.eval_tokens(token_lists)
    return emb, eng.stats()["buckets"], events


def _train_job(config, params, dp, tp, lr, batches, pooling="mean",
               ckpt_in=None, ckpt_out=None):
    """make_sharded_train_step on a (dp, tp) CPU mesh from ``params`` (a
    dense host tree) or the train state in ``ckpt_in``, one step per
    batch; per step its loss, grad_norm, step and the whole parameters,
    first moments and count. Saves the state to ``ckpt_out``."""
    from .checkpoint import load_train_state, save_train_state
    from .model import TrainableBertModel
    from .parallel.mesh import make_mesh
    from .params import params_to_numpy, params_to_torch
    from .train import (adam_moments, init_train_state, make_optimizer,
                        make_sharded_train_step)

    mesh = make_mesh(dp * tp, tp=tp, device_type="cpu")
    opt = make_optimizer(lr)
    state = init_train_state(TrainableBertModel(
        params_to_torch(params, device="cpu"), config), opt)
    if ckpt_in:
        state = load_train_state(ckpt_in, state)
    state, step = make_sharded_train_step(mesh, config, opt, state,
                                          pooling=pooling)
    steps = []
    for batch in batches:
        state, m = step(state, batch)
        mu, _, count = adam_moments(state)
        steps.append({"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "step": state.step, "count": count,
                      "params": params_to_numpy(state.params), "mu": mu})
    if ckpt_out:
        save_train_state(ckpt_out, state)
    return steps


def _row_parallel_job(h, w, tp):
    """The row-parallel product of bf16 ``h`` [M, K] and ``w`` [K, N] on a
    (1, tp) CPU mesh: each rank multiplies its K shard
    (model._row_parallel), as f32 numpy."""
    import torch

    from .model import _row_parallel
    from .parallel.mesh import MODEL_AXIS, axis_group, axis_index, make_mesh

    mesh = make_mesh(tp, tp=tp, device_type="cpu")
    m, k = axis_index(mesh, MODEL_AXIS), h.shape[1] // tp
    hs = torch.from_numpy(h[:, m * k:(m + 1) * k]).to(torch.bfloat16)
    ws = torch.from_numpy(np.ascontiguousarray(w[m * k:(m + 1) * k]))
    out = _row_parallel(hs, ws, axis_group(mesh, MODEL_AXIS), None)
    return out.float().numpy()


def _multihost_job(tp):
    """multihost's plumbing on a CPU global_mesh(tp): this rank's rows of
    a whole batch, the batch put back together from every rank's rows,
    the data axis's ranks all-gathered, and global_mesh's refusal of a tp
    that does not divide the ranks of a host."""
    import torch.distributed as dist

    from .parallel import multihost

    mesh = multihost.global_mesh(tp, device_type="cpu")
    whole = np.arange(16, dtype=np.float32).reshape(8, 2)
    mine = multihost.global_to_host_local(mesh, whole)
    try:
        multihost.global_mesh(dist.get_world_size() + 1, device_type="cpu")
        refusal = None
    except ValueError as e:
        refusal = str(e)
    return {"mine": mine,
            "whole": multihost.host_local_batch_to_global(mesh, mine),
            "ranks": multihost.allgather(
                mesh, np.asarray([dist.get_rank()]), tiled=False),
            "refusal": refusal}


class _FailsFirst:
    """An engine whose first ``eval_tokens`` raises, on every rank alike,
    before any collective: a batch that fails the same way everywhere."""

    def __init__(self, model):
        self._model, self.raised = model, 0

    def __getattr__(self, name):
        return getattr(self._model, name)

    def eval_tokens(self, token_lists):
        if not self.raised:
            self.raised += 1
            raise RuntimeError("this batch fails")
        return self._model.eval_tokens(token_lists)


def _batch_request(port: int, token_lists):
    """One framed BATCH message to the server on ``port``: its [n, D]
    reply, or None when the server closes the connection instead."""
    import socket
    import struct

    from .server import BIN_BATCH_MAGIC

    with socket.create_connection(("127.0.0.1", port), 60) as sock:
        (n_embd,) = struct.unpack("<i", sock.recv(4))
        msg = BIN_BATCH_MAGIC + struct.pack("<i", len(token_lists))
        for t in token_lists:
            msg += struct.pack("<i", len(t)) + np.asarray(t, "<i4").tobytes()
        sock.sendall(msg)
        want, buf = len(token_lists) * n_embd * 4, b""
        while len(buf) < want:
            more = sock.recv(want - len(buf))
            if not more:
                return None
            buf += more
    return np.frombuffer(buf, "<f4").reshape(len(token_lists), n_embd)


def _server_job(loaded, dp, tp, token_lists, engine_kw):
    """The sharded server with a batch that fails on every rank: rank 0
    serves (ShardedLeader, its scheduler on a ServerThread) and sends two
    BATCH messages itself, the other ranks follow. Returns, the same on
    every rank, the second reply, whether the first failed, and how many
    batches raised on this rank."""
    import torch.distributed as dist

    from .engine import BertTorch
    from .server import ServerThread, ShardedLeader, follow

    model = _FailsFirst(BertTorch(loaded, device="cpu", dp=dp, tp=tp,
                                  **engine_kw))
    replies = [None]
    if dist.get_rank() == 0:
        leader = ShardedLeader(model)
        with ServerThread(leader) as st:
            replies = [[_batch_request(st.port, token_lists)
                        for _ in range(2)]]
        leader.stop_followers()
    else:
        follow(model)
    dist.broadcast_object_list(replies, src=0)
    first, second = replies[0]
    return second, (first is None, model.raised)


def _plans(programs):
    """Each segmented program's collectives, by key: (op, the group's
    global ranks) in order."""
    import torch.distributed as dist

    return {key: [(op.op, dist.get_process_group_ranks(op.group))
                  for op in prog.plan]
            for key, prog in programs.table.items()
            if getattr(prog, "plan", None) is not None}


def _graphs_engine_job(loaded, dp, tp, token_lists, engine_kw, warmup):
    """A mesh engine's programs on the CPU: the keys ``warmup(**warmup)``
    made, the embeddings of ``token_lists`` twice (the second call replays
    the first's programs), the same with the programs set aside, the
    bucket counts and the programs' collectives (:func:`_plans`)."""
    from .engine import BertTorch

    eng = BertTorch(loaded, device="cpu", dp=dp, tp=tp, **engine_kw)
    eng.warmup(**warmup)
    warm = set(eng._programs.table)
    eng = BertTorch(loaded, device="cpu", dp=dp, tp=tp, **engine_kw)
    got = [eng.eval_tokens(token_lists) for _ in range(2)]
    programs, eng._programs = eng._programs, None
    eager = eng.eval_tokens(token_lists)
    return {"warm_keys": warm, "programs": got, "eager": eager,
            "buckets": eng.stats()["buckets"], "plans": _plans(programs)}


def _graphs_encode_job(config, params_by_name, dp, tp, poolings, ids, mask):
    """make_sharded_encode_fn's programs on a (dp, tp) CPU mesh: for each
    host tree and pooling, the [B, D] result of two calls (the first's
    result held across the second), the program keys, and the
    programs' collectives."""
    import torch

    from .parallel.mesh import make_mesh
    from .parallel.spmd import make_sharded_encode_fn, shard_params

    mesh = make_mesh(dp * tp, tp=tp, device_type="cpu")
    out = {}
    for name, host in params_by_name.items():
        shard = shard_params(mesh, host)
        for pooling in poolings:
            fn = make_sharded_encode_fn(mesh, config,
                                        compute_dtype=torch.float32,
                                        pooling=pooling, params_example=host)
            first = fn(shard, ids, mask)
            second = fn(shard, torch.from_numpy(ids), mask)
            out[(name, pooling)] = {
                "first": first.numpy(), "second": second.numpy(),
                "keys": [k[:2] for k in fn.programs.table],
                "plans": list(_plans(fn.programs).values())}
    return out


def _wire_job(loaded, dp, tp, ids, mask):
    """This mesh's bucketed forward of [B, T] ``ids``/``mask`` in f32
    compute, with each wire dtype: {wire: [B, D] numpy, as the wire
    carries it}."""
    import torch

    from .engine import BertTorch

    out = {}
    for wire in ("f32", "f16", "int8"):
        eng = BertTorch(loaded, device="cpu", dp=dp, tp=tp,
                        compute_dtype=torch.float32, wire_dtype=wire)
        with torch.inference_mode():
            out[wire] = eng._forward(ids, mask).numpy()
    return out


class FakeCard:
    """The card's objects for a :class:`~._graphs.SegmentedProgram` run
    on the CPU: streams that do nothing, and graphs that log their capture
    and replay to ``events`` and, while one captures, take the "kernels"
    of :meth:`launch` instead of running them; a replay runs them."""

    def __init__(self, events, fail_replay=False):
        self.events, self.fail_replay = events, fail_replay
        self.capturing = None
        card = self

        class Graph:
            def __init__(self):
                self.kernels = []

            def capture_begin(self, pool=None, capture_error_mode="global"):
                assert capture_error_mode == "thread_local"
                card.capturing = self
                card.events.append("begin")

            def capture_end(self):
                card.capturing = None
                card.events.append("end")

            def replay(self):
                card.events.append("replay")
                if card.fail_replay:
                    raise RuntimeError("this replay fails")
                for k in self.kernels:
                    k()
        self.Graph = Graph

    def launch(self, kernel, counter):
        """A kernel launched from Python: counted, then run, or taken by
        the graph being captured."""
        counter.launches += 1
        if self.capturing is not None:
            self.capturing.kernels.append(kernel)
        else:
            kernel()
            self.events.append("kernel")

    @contextlib.contextmanager
    def installed(self):
        """torch.cuda's graph and stream objects replaced by these, and
        torch.distributed's collectives logged to ``events``."""
        import torch
        import torch.distributed as dist

        stream = type("Stream", (), {"wait_stream": lambda s, o: None})()
        fakes = {"Stream": lambda dev=None: stream,
                 "current_stream": lambda dev=None: stream,
                 "stream": lambda s: contextlib.nullcontext(),
                 "synchronize": lambda dev=None: None,
                 "CUDAGraph": self.Graph}
        reduce_, gather = dist.all_reduce, dist.all_gather

        def all_reduce(t, op=dist.ReduceOp.SUM, group=None, **kw):
            self.events.append("all_reduce" if op == dist.ReduceOp.SUM
                               else "check")
            return reduce_(t, op=op, group=group, **kw)

        def all_gather(parts, t, group=None, **kw):
            self.events.append("all_gather")
            return gather(parts, t, group=group, **kw)
        saved = {k: getattr(torch.cuda, k) for k in fakes}
        for k, v in fakes.items():
            setattr(torch.cuda, k, v)
        dist.all_reduce, dist.all_gather = all_reduce, all_gather
        try:
            yield self
        finally:
            for k, v in saved.items():
                setattr(torch.cuda, k, v)
            dist.all_reduce, dist.all_gather = reduce_, gather


def _fake_card_job(fail_capture=None, fail_replay=None):
    """A :class:`~._graphs.SegmentedProgram` taking the card's path on a
    (1, world) CPU mesh with :class:`FakeCard`: a function of two
    segments (a kernel, an all-reduce over ``model``, a kernel) whose
    rows are gathered over every rank. Returns the events and results of
    two calls, and the launch count after each; or, where rank
    ``fail_capture`` raises inside the capture (or ``fail_replay``'s
    graph replay raises at the second call), what each rank raised."""
    import os
    import types

    import torch
    import torch.distributed as dist

    from ._graphs import SegmentedProgram
    from .parallel.collectives import all_reduce_
    from .parallel.mesh import MODEL_AXIS, axis_group, make_mesh

    world = int(os.environ["WORLD_SIZE"])
    mesh = make_mesh(world, tp=world, device_type="cpu")
    rank = dist.get_rank()
    events: list = []
    card = FakeCard(events)
    counter = types.SimpleNamespace(launches=0)

    def fn(x):
        if card.capturing is not None and rank == fail_capture:
            raise RuntimeError("this capture fails")
        a = torch.empty(3)
        card.launch(lambda: a.copy_(x * (rank + 1)), counter)
        all_reduce_(a, axis_group(mesh, MODEL_AXIS))
        b = torch.empty(3)
        card.launch(lambda: b.copy_(a * 2), counter)
        return b
    prog = SegmentedProgram(fn, {"x": torch.zeros(3)}, pool="pool",
                            counters=[counter], gather=dist.group.WORLD)
    prog.device = torch.device("cuda")  # take the card's path
    out = {"calls": []}
    with card.installed():
        for i, x in enumerate(([1.0, 2.0, 3.0], [0.0, -1.0, 5.0])):
            card.fail_replay = i == 1 and rank == fail_replay
            try:
                got = prog(x=np.asarray(x, np.float32)).numpy().copy()
            except RuntimeError as e:
                out["calls"].append({"raised": str(e),
                                     "events": list(events)})
                break
            out["calls"].append({"out": got, "events": list(events),
                                 "launches": counter.launches})
            events.clear()
    out["graphs"], out["plan"] = len(prog.graphs), [
        op.op for op in prog.plan or ()]
    return out


_JOBS = {"encode": _encode_job, "engine": _engine_job, "train": _train_job,
         "row_parallel": _row_parallel_job, "multihost": _multihost_job,
         "server": _server_job, "graphs_engine": _graphs_engine_job,
         "graphs_encode": _graphs_encode_job, "wire": _wire_job,
         "fake_card": _fake_card_job}


def rank_jobs(jobs):
    """Run ``jobs`` — (name, kwargs) pairs of :data:`_JOBS` — in order on
    this rank; returns their results. Raises if JAX or bert_tpu came to
    be imported."""
    import sys

    out = [_JOBS[name](**kw) for name, kw in jobs]
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "bert_tpu"))
    if bad:
        raise AssertionError(f"a rank imported {bad}")
    return out

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
import threading
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
               ckpt_in=None, ckpt_out=None, jit=True):
    """make_sharded_train_step(jit=) on a (dp, tp) CPU mesh from
    ``params`` (a dense host tree) or the train state in ``ckpt_in``, one
    step per batch; per step its loss, grad_norm, step and the whole
    parameters, first moments and count. Saves the state to
    ``ckpt_out``."""
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
                                          pooling=pooling, jit=jit)
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


def sharded_train_plan(model, dp: int, tp: int, rows: int, seq: int
                       ) -> list:
    """The collectives of one ``make_sharded_train_step`` step on a rank
    of a (dp, tp) mesh whose ``model`` (a TrainableBertModel shard) takes
    ``rows`` rows of ``seq`` tokens a side, in the order the step issues
    them: (op, axis, shape of the tensor). A group of one rank issues
    nothing.

    - each forward (side a, then b): *g* after each row-parallel product,
      2 a layer, over ``model``; then its rows' all-gather over ``data``;
    - the backward, 4 a layer a side, all over ``model`` on [rows, seq,
      D]: the remat recompute's two *g* (the non-reentrant checkpoint
      stops early only after the layer's last LayerNorm, which takes the
      second *g*'s sum) and *f*'s all-reduce at the QKV and FFN-up
      inputs. Both sides' are alike, so their interleaving does not show;
    - each leaf's gradient, in ``model.tree()``'s order: summed over
      ``data``, then a replicated leaf's broadcast over ``model``;
    - the sharded leaves' squared norm (0-d) summed over ``model``.

    With tp > 1 that is 12·L + 2·(dp > 1) + leaves·(dp > 1) + replicated
    leaves + 1 collectives; the program holds one graph more."""
    from .parallel.sharding import split_dim

    d, n_layer = model.config.n_embd, model.config.n_layer
    model_ar = ("all_reduce", "model", (rows, seq, d))
    fwd = [model_ar] * (2 * n_layer * (tp > 1))
    gather = [("all_gather", "data", (rows, d))] * (dp > 1)
    plan = (fwd + gather) * 2 + [model_ar] * (8 * n_layer * (tp > 1))
    for group, sub in model.tree().items():
        for key, p in sub.items():
            shape = tuple(p.shape)
            plan += [("all_reduce", "data", shape)] * (dp > 1)
            plan += [("broadcast", "model", shape)] * (
                tp > 1 and split_dim(group, key) is None)
    return plan + [("all_reduce", "model", ())] * (tp > 1)


def plan_axes(plan, mesh) -> list:
    """A program's collectives as (op, axis, shape): each group named by
    the mesh axis whose group it is."""
    import torch.distributed as dist

    from .parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_group

    def ranks(group):
        return tuple(dist.get_process_group_ranks(group))
    names = {ranks(axis_group(mesh, a)): a for a in (DATA_AXIS, MODEL_AXIS)
             if axis_group(mesh, a) is not None}
    return [(op.op, names.get(ranks(op.group), "?"), tuple(op.tensor.shape))
            for op in plan]


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
    of :meth:`launch` instead of running them, from any thread (a stream
    capture takes the stream's work whoever launches it); a replay runs
    them. As on the card, a collective of the card's tensors that runs
    while a graph captures raises (gloo's copies through the host would
    invalidate the capture; a check's tensor is the host's), and so does
    ending a capture on another thread than the one that began it, unless
    it was begun in relaxed mode. An event from another thread than the
    one that made the card is logged with ``@autograd``: there it stands
    for autograd's device thread."""

    def __init__(self, events, fail_replay=False):
        self.events, self.fail_replay = events, fail_replay
        self.capturing = None
        self.home = threading.get_ident()
        card = self

        class Graph:
            def __init__(self):
                self.kernels = []

            def capture_begin(self, pool=None, capture_error_mode="global"):
                assert capture_error_mode in ("thread_local", "relaxed")
                self.mode, self.thread = (capture_error_mode,
                                          threading.get_ident())
                card.capturing = self
                card.log("begin")

            def capture_end(self):
                if (self.mode != "relaxed"
                        and threading.get_ident() != self.thread):
                    raise RuntimeError("CUDA error: a capture not begun in "
                                       "relaxed mode ended on another "
                                       "thread "
                                       "(cudaErrorStreamCaptureWrongThread)")
                card.capturing = None
                card.log("end")

            def replay(self):
                card.log("replay")
                if card.fail_replay:
                    raise RuntimeError("this replay fails")
                for k in self.kernels:
                    k()
        self.Graph = Graph

    def log(self, event: str) -> None:
        self.events.append(event if threading.get_ident() == self.home
                           else event + "@autograd")

    def launch(self, kernel, counter):
        """A kernel launched from Python: counted, then run, or taken by
        the graph being captured."""
        counter.launches += 1
        if self.capturing is not None:
            self.capturing.kernels.append(kernel)
        else:
            kernel()
            self.log("kernel")

    def collective(self, name: str) -> None:
        if self.capturing is not None and name != "check":  # check: host
            raise RuntimeError("CUDA error: operation not permitted when "
                               f"stream is capturing ({name})")
        self.log(name)

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
        real = {k: getattr(dist, k)
                for k in ("all_reduce", "all_gather", "broadcast")}

        def all_reduce(t, op=dist.ReduceOp.SUM, group=None, **kw):
            self.collective("all_reduce" if op == dist.ReduceOp.SUM
                            else "check")
            return real["all_reduce"](t, op=op, group=group, **kw)

        def all_gather(parts, t, group=None, **kw):
            self.collective("all_gather")
            return real["all_gather"](parts, t, group=group, **kw)

        def broadcast(t, src, group=None, **kw):
            self.collective("broadcast")
            return real["broadcast"](t, src=src, group=group, **kw)
        saved = {k: getattr(torch.cuda, k) for k in fakes}
        for k, v in fakes.items():
            setattr(torch.cuda, k, v)
        dist.all_reduce, dist.all_gather, dist.broadcast = (
            all_reduce, all_gather, broadcast)
        try:
            yield self
        finally:
            for k, v in saved.items():
                setattr(torch.cuda, k, v)
            for k, v in real.items():
                setattr(dist, k, v)


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


def _collectives_job():
    """The ``"broadcast"`` :class:`~.parallel.collectives.Collective` and
    the recorder paths on a (1, world) CPU mesh, rank r's tensor r + 1:
    ``broadcast_`` without a recorder and with this thread's (the CPU's
    recorder runs and records it), the recorded op run again on new
    values and stood in for by each rank in turn, its signature; the
    process's recorder (``every_thread``) taking a broadcast issued on
    another thread, and given back after a raise; and an all-gather
    recorded inside an autograd Function's forward (its output is
    autograd's, as in a train capture), run again on new rows."""
    import os

    import torch
    import torch.distributed as dist

    from ._graphs import _Segments
    from .parallel import collectives as coll
    from .parallel.mesh import MODEL_AXIS, axis_group, make_mesh

    world = int(os.environ["WORLD_SIZE"])
    group = axis_group(make_mesh(world, tp=world, device_type="cpu"),
                       MODEL_AXIS)
    rank = dist.get_rank()
    out = {}
    t = torch.full((3,), rank + 1.0)
    out["eager"] = coll.broadcast_(t, group).numpy().copy()
    t.fill_(rank + 1.0)
    with coll.recording(_Segments()) as rec:
        got = coll.broadcast_(t, group)
    (op,) = rec.ops
    out["recorded"] = (op.op, got is t, t.numpy().copy(), op.signature())
    t.fill_(10.0 * (rank + 1))
    op.run()
    out["run"] = t.numpy().copy()
    for standing in range(world):  # each rank stands in once
        t.fill_(7.0 * (rank + 1))
        op.stand_in() if rank == standing else op.run()
        out[f"rank {standing} stands in"] = t.numpy().copy()

    rec = _Segments()
    with coll.recording(rec, every_thread=True):
        on_another_thread(lambda: coll.broadcast_(t, group))
    try:
        with coll.recording(_Segments(), every_thread=True):
            raise KeyError("inside")
    except KeyError:
        pass
    out["every_thread"] = ([o.op for o in rec.ops], coll._shared.recorder,
                           coll._shared_lock.locked())

    x = torch.full((2, 3), rank + 1.0, requires_grad=True)
    with coll.recording(_Segments()) as rec:
        y = coll.gather_rows(x * 1.0, group)
    (op,) = rec.ops
    with torch.no_grad():
        op.tensor.fill_(-(rank + 1.0))
    op.run()
    out["gather"] = (y.requires_grad, op.out is y, y.detach().numpy().copy())
    return out


def on_another_thread(work) -> None:
    """Run ``work()`` on a thread of its own and wait for it, as autograd
    runs a backward's CUDA work on its device thread while the caller
    waits; its error is raised here."""
    error = []

    def run():
        try:
            work()
        except BaseException as e:  # raised below, in the caller's thread
            error.append(e)
    t = threading.Thread(target=run, name="autograd")
    t.start()
    t.join()
    if error:
        raise error[0]


FAKE_TRAIN_INPUTS = ([1.0, 2.0, 3.0], [0.0, -1.0, 5.0], [2.0, 2.0, 2.0],
                     [1.0, 2.0, 3.0])


def _fake_train_job(fail_capture=None, fail_replay=None):
    """A :class:`~._graphs.SegmentedTrainProgram` taking the card's path
    on a (1, world) CPU mesh with :class:`FakeCard`, kept in a program
    table: a step of five segments whose backward runs on another thread
    (:func:`on_another_thread`), as on the card. Forward: a kernel, *g*
    over ``model``; backward: a kernel, *f*'s all-reduce over ``model``,
    the gradient's kernel; then the gradient summed over every rank (the
    ``data`` group's stand-in) and broadcast over ``model``, and the
    update's kernel. One call for each of :data:`FAKE_TRAIN_INPUTS`; the
    optimizer's state is placed anew before the fourth. Returns each
    call's events, output, launch count and program, and whether the
    parameter's gradient was the program's after each replay; or, where
    rank ``fail_capture`` raises inside the backward's capture (or
    ``fail_replay``'s graph replay raises at the third call), what each
    rank raised."""
    import functools
    import os
    import types

    import torch
    import torch.distributed as dist

    from ._graphs import Programs, SegmentedTrainProgram
    from .parallel.collectives import all_reduce_, broadcast_
    from .parallel.mesh import MODEL_AXIS, axis_group, make_mesh

    world = int(os.environ["WORLD_SIZE"])
    mesh = make_mesh(world, tp=world, device_type="cpu")
    tp_group, data = axis_group(mesh, MODEL_AXIS), dist.group.WORLD
    rank = dist.get_rank()
    events: list = []
    card = FakeCard(events)
    counter = types.SimpleNamespace(launches=0)
    model = torch.nn.ParameterList([torch.nn.Parameter(torch.zeros(3))])
    (w,) = model.parameters()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    opt.state[w] = {"momentum_buffer": torch.zeros(3)}

    def step(x):
        a = torch.empty(3)
        card.launch(lambda: a.copy_(x * (rank + 1)), counter)
        all_reduce_(a, tp_group)
        g, grad = torch.empty(3), torch.empty(3)

        def backward():
            if card.capturing is not None and rank == fail_capture:
                raise RuntimeError("this capture fails")
            card.launch(lambda: g.copy_(a * 2), counter)
            all_reduce_(g, tp_group)
            card.launch(lambda: grad.copy_(g + 1), counter)
        on_another_thread(backward)
        w.grad = grad
        all_reduce_(grad, data)
        broadcast_(grad, tp_group)
        out = torch.empty(3)
        card.launch(lambda: out.copy_(grad * 3), counter)
        return (out,)

    table = Programs(torch.device("cpu"))
    table.pool = "pool"
    make = functools.partial(SegmentedTrainProgram, model=model, opt=opt,
                             counters=[counter])
    out = {"calls": [], "programs": []}
    with card.installed():
        for i, x in enumerate(FAKE_TRAIN_INPUTS):
            if i == 3:  # moments placed anew: the program is not current
                opt.state[w] = {"momentum_buffer": torch.zeros(3)}
            arrays = {"x": np.asarray(x, np.float32)}
            prog = table.get(("key",), step, arrays, make)
            prog.device = torch.device("cuda")  # take the card's path
            card.fail_replay = i == 2 and rank == fail_replay
            try:
                (got,) = prog(**arrays)
            except RuntimeError as e:
                out["calls"].append({"raised": str(e),
                                     "events": list(events)})
                break
            if prog not in out["programs"]:
                out["programs"].append(prog)
            out["calls"].append({
                "out": got.numpy().copy(), "events": list(events),
                "launches": counter.launches,
                "program": out["programs"].index(prog),
                "grad_is_programs": bool(prog.grads
                                         and w.grad is prog.grads[0])})
            events.clear()
    first = out.pop("programs")[:1]
    out["graphs"] = [len(p.graphs) for p in first]
    out["plan"] = [[op.op for op in p.plan or ()] for p in first]
    return out


def _graphs_train_job(config, params, dp, tp, lr, batches):
    """make_sharded_train_step's program (``jit=True``) and its eager twin
    (``jit=False``) on a (dp, tp) CPU mesh from the same ``params``, one
    step per batch each: every step's loss and grad_norm and this rank's
    parameters and both moments as they are (its shards); the program's
    gathered parameters, first moments and count for a hold against
    bert_tpu; the program table's keys, its collectives as (op, axis,
    shape) (:func:`plan_axes`) and what :func:`sharded_train_plan`
    derives."""
    import torch

    from .model import TrainableBertModel
    from .parallel.mesh import make_mesh
    from .params import params_to_numpy, params_to_torch
    from .train import (adam_moments, init_train_state, make_optimizer,
                        make_sharded_train_step)

    mesh = make_mesh(dp * tp, tp=tp, device_type="cpu")
    out = {}
    for jit in (True, False):
        opt = make_optimizer(lr)
        state = init_train_state(TrainableBertModel(
            params_to_torch(params, device="cpu"), config), opt)
        state, step = make_sharded_train_step(mesh, config, opt, state,
                                              jit=jit)
        rows = []
        for b in batches:
            state, m = step(state, b)
            st = state.opt_state.state
            rows.append({
                "loss": m["loss"].numpy().copy(),
                "grad_norm": m["grad_norm"].numpy().copy(),
                "tensors": {f"{g}/{k}": [t.detach().numpy().copy() for t in (
                    p, st[p]["exp_avg"], st[p]["exp_avg_sq"])]
                    for g, sub in state.params.tree().items()
                    for k, p in sub.items()}})
            if jit:
                mu, _, count = adam_moments(state)
                rows[-1].update(params=params_to_numpy(state.params), mu=mu,
                                count=count, step=state.step)
        out[jit] = rows
        if jit:
            table = step.programs[torch.device("cpu")].table
            out["keys"] = [k[:2] for k in table]
            out["plan"] = plan_axes(next(iter(table.values())).plan, mesh)
            ids = batches[0]["ids_a"]
            out["want"] = sharded_train_plan(state.params, dp, tp,
                                             ids.shape[0] // dp,
                                             ids.shape[1])
    return out


_JOBS = {"encode": _encode_job, "engine": _engine_job, "train": _train_job,
         "row_parallel": _row_parallel_job, "multihost": _multihost_job,
         "server": _server_job, "graphs_engine": _graphs_engine_job,
         "graphs_encode": _graphs_encode_job, "wire": _wire_job,
         "fake_card": _fake_card_job, "fake_train": _fake_train_job,
         "collectives": _collectives_job,
         "graphs_train": _graphs_train_job}


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

"""The engine's and the trainer's compiled programs: one CUDA graph per
batch shape.

bert_tpu jit-compiles its forward once per (rows, T) shape and weight tree
(``jax.jit(encode)``, ``jax.jit(encode_packed)`` and
``jax.jit(gather_segments)``, bert_tpu/engine.py:213-232, :265-267), so a
batch costs the host one dispatch. The PyTorch counterpart of such a
program is a CUDA graph: a :class:`Program` is one function over static
device inputs, captured once and replayed with one host call.

On the card a program's first call

1. copies the batch into its static inputs,
2. runs the function once eagerly on a side stream: that loads the
   kernels' libraries, sets each kernel's shared-memory attribute once and
   creates cuBLAS's handle and workspace, none of which a capture may do;
3. captures the function into a CUDA graph whose memory comes from the
   pool that every program of its :class:`Programs` table shares (replays
   run one at a time on one stream, so their scratch may overlap), and
4. replays the graph.

Every later call copies the batch into the static inputs and replays.
Each call rewrites every element of every static input (the caller passes
arrays of the full static shape, padded), so nothing of an earlier batch
survives. A capture or replay that fails raises: no batch goes eager on
the card. On the CPU nothing is captured: the same staging runs, then the
function is called eagerly, so the CPU tests exercise the staging that the
card uses.

A program's static output is overwritten by its next replay, and a replay
may overwrite the output of a program captured after it (their scratch
shares the pool). So the caller consumes an output (queues its copy to the
host, or replays a program that reads it) on the same stream before the
next replay, and threads that share a table take turns (the engine's
lock) from staging a batch to queueing its copy.

A :class:`SegmentedProgram` is a mesh rank's program: bert_tpu's
``sharded_jit(encode)`` (bert_tpu/engine.py:234-261), whose collectives
cannot sit inside a graph that gloo runs (it stages them through the
host). Its capture ends a graph at each collective and begins the next,
and its replay runs graph, collective, graph, ... (the class says how).

A :class:`TrainProgram` is the trainer's counterpart of bert_tpu's
jitted train step (``jax.jit(train_step)``, bert_tpu/train.py:128): its
function is a whole step, forward, backward and optimizer update, whose
every call is a real step. Its first runs eagerly, its second is captured
and replayed, and the graph is bound to the parameters and optimizer
state it was captured on (the class says how).

A :class:`SegmentedTrainProgram` is a mesh rank's train step, bert_tpu's
GSPMD step (``jax.jit(step_fn, in_shardings=...)``,
bert_tpu/train.py:201-206): a :class:`TrainProgram`'s lifecycle with a
:class:`SegmentedProgram`'s segments. Its backward's collectives are
issued from autograd's device thread on the card, so its capture sets
the recorder for every thread of the process
(``collectives.recording(rec, every_thread=True)``) and captures in
CUDA's relaxed mode, in which that thread may end a graph begun on the
step's thread and begin the next.

A table made with the engine's :class:`~.profiling.PhaseTimers` times each
call's parts as parts of the engine's dispatch: ``dispatch.stage`` (the
copies into the static inputs), ``dispatch.capture`` (a new shape's warm
run and capture) and ``dispatch.replay`` (on the CPU, the eager run). A
table made without records none.

The kernel wrappers count their launches in Python (``<wrapper>.launches``),
and a replay runs no Python. :func:`capture_counted` therefore takes back
what the capture counted and :meth:`Program.replay` adds it again, so a
counter keeps meaning "kernels the card ran": the eager warm-up run
counts, the capture does not, and each replay counts once.
"""

from __future__ import annotations

import contextlib
import itertools
import time
import warnings
import zlib
from typing import (Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

from .ops.attention import multi_head_attention
from .ops.fused_attention import fused_qkv_attention
from .ops.int8_matmul import (int8_matmul, int8_matmul_gelu,
                              quantize_activations_i8)
from .ops.layer_norm import fused_layer_norm, fused_layer_norm_codes
from .ops.q4_matmul import q4_matmul
from .parallel.collectives import Collective, recording

# every kernel wrapper's launch counter, and q4_matmul's count of its
# wgmma instance
COUNTERS = (q4_matmul, fused_layer_norm, fused_layer_norm_codes,
            fused_qkv_attention, multi_head_attention, int8_matmul,
            int8_matmul_gelu, quantize_activations_i8, q4_matmul.wgmma)


def capture_counted(counters: Sequence, capture: Callable[[], None]
                    ) -> List[int]:
    """Run ``capture`` and take back what it added to each counter (a
    capture launches nothing); returns those deltas, what one replay of
    the captured work launches."""
    before = [c.launches for c in counters]
    capture()
    delta = [c.launches - b for c, b in zip(counters, before)]
    for c, b in zip(counters, before):
        c.launches = b
    return delta


def add_launches(counters: Sequence, delta: Sequence[int]) -> None:
    for c, d in zip(counters, delta):
        c.launches += d


class Program:
    """One function of static inputs, as a CUDA graph on the card.

    ``inputs`` maps each of ``fn``'s keyword arguments to its static
    tensor; :meth:`__call__` copies arrays of the same shapes and dtypes
    into them and returns :attr:`output`, the function's result (on the
    card the graph's static output, overwritten by the next replay)."""

    def __init__(self, fn: Callable[..., torch.Tensor],
                 inputs: Dict[str, torch.Tensor], pool=None,
                 counters: Sequence = COUNTERS):
        self.fn = fn
        self.inputs = inputs
        self.device = next(iter(inputs.values())).device
        self._np_dtypes = {name: torch.empty(0, dtype=t.dtype).numpy().dtype
                           for name, t in inputs.items()}
        self.pool = pool
        self.counters = counters
        self.output: Optional[torch.Tensor] = None
        self.graph = None
        self.launches: Optional[List[int]] = None  # one replay's, by counter
        self.timers = None  # the PhaseTimers its table times its calls by

    def stage(self, arrays: Dict[str, np.ndarray]) -> None:
        """Copy every input array into its static tensor, whole."""
        if arrays.keys() != self.inputs.keys():
            raise ValueError(f"program inputs {sorted(self.inputs)}, got "
                             f"{sorted(arrays)}")
        for name, a in arrays.items():
            t = self.inputs[name]
            if a.shape != tuple(t.shape):
                raise ValueError(f"program input {name}: shape {a.shape}, "
                                 f"static {tuple(t.shape)}")
            # converted on the host: a converting copy launches a kernel
            t.copy_(torch.from_numpy(np.ascontiguousarray(
                a, dtype=self._np_dtypes[name])), non_blocking=True)

    def _phase(self, name: str):
        if self.timers is None:
            return contextlib.nullcontext()
        return self.timers.phase(name)

    def __call__(self, **arrays: np.ndarray) -> torch.Tensor:
        with self._phase("dispatch.stage"):
            self.stage(arrays)
        if self.device.type != "cuda":  # nothing is captured
            with self._phase("dispatch.replay"):
                self._run_eagerly()
            return self.output
        if self.graph is None:
            with self._phase("dispatch.capture"):
                self._capture()
        with self._phase("dispatch.replay"):
            self.replay()
        return self.output

    def current(self) -> bool:
        """Whether the tensors the program works on are still the ones it
        was made for (a forward program's inputs are its own: always)."""
        return True

    def _capture(self) -> None:
        self._warm()
        self._record()

    def _run_eagerly(self) -> None:
        """The CPU's call: the function, eagerly."""
        self.output = self.fn(**self.inputs)

    def _warm(self) -> None:
        """Run the function eagerly on a side stream (what a capture may
        not do happens here) and wait for it."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.output = self.fn(**self.inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)

    def _record(self) -> None:
        """Capture the function into this program's graph (it runs
        nothing); the replays run it."""
        graph = torch.cuda.CUDAGraph()

        def capture():
            # thread_local: a server thread that synchronizes on an event
            # while another thread captures is not refused
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                self.output = self.fn(**self.inputs)
        self.launches = capture_counted(self.counters, capture)
        self.graph = graph

    def replay(self) -> None:
        """Run the captured graph on the static inputs as they are."""
        self.graph.replay()
        add_launches(self.counters, self.launches)


class Programs:
    """An engine's program table: key → :class:`Program`, all sharing one
    memory pool on the card; with ``timers``, each program's calls are
    timed as phases of them."""

    def __init__(self, device: torch.device, timers=None):
        self.device = device
        self.pool = (torch.cuda.graph_pool_handle()
                     if device.type == "cuda" else None)
        self.timers = timers
        self.table: Dict[Hashable, Program] = {}

    def get(self, key: Hashable, fn: Callable[..., torch.Tensor],
            arrays: Dict[str, np.ndarray],
            program: Callable[..., Program] = Program) -> Program:
        """The program of ``key``: ``program(fn, static inputs, pool)``,
        its static inputs shaped and typed as ``arrays``, made the first
        time the key is asked for (captured at its first calls), and made
        anew where the key's program is no longer :meth:`Program.current`."""
        prog = self.table.get(key)
        if prog is None or not prog.current():
            inputs = {name: torch.tensor(a, device=self.device)  # a copy
                      for name, a in arrays.items()}
            prog = self.table[key] = program(fn, inputs, self.pool)
            prog.timers = self.timers
        return prog


class _Segments:
    """The recorder of a :class:`SegmentedProgram`'s capture pass
    (``collectives.recording``). On the card (``card``) each
    collective ends the graph being captured, is recorded and not run (the
    captured kernels have not run: its tensor holds nothing yet), and the
    next graph begins in the same pool; elsewhere each collective runs and
    is recorded. ``relaxed``: the graphs are captured in CUDA's relaxed
    mode, so another thread than the one that began a graph may end it (a
    train step's backward, on autograd's device thread); otherwise
    thread_local, as a forward's."""

    def __init__(self, pool=None, card: bool = False, relaxed: bool = False):
        self.pool, self.card = pool, card
        self.mode = "relaxed" if relaxed else "thread_local"
        self.graphs: list = []
        self.ops: List[Collective] = []
        self._open = None

    def begin(self) -> None:
        self._open = torch.cuda.CUDAGraph()
        self._open.capture_begin(pool=self.pool,
                                 capture_error_mode=self.mode)

    def end(self) -> None:
        with warnings.catch_warnings():
            # two collectives in a row (a gradient summed over data, then
            # broadcast over model) leave an empty graph between them
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            self._open.capture_end()
        # kept open where the end raised, for abandon() to end
        self.graphs.append(self._open)
        self._open = None

    def abandon(self) -> None:
        """End a capture that raised (its graph is not kept)."""
        graph, self._open = self._open, None
        if graph is not None:
            try:
                graph.capture_end()
            except RuntimeError:  # the capture was invalidated
                pass

    def _boundary(self, make: Callable[[], Collective]) -> Collective:
        if not self.card:
            op = make()
            op.run()
        else:
            self.end()
            op = make()  # an all-gather's output lies outside the pool
            self.begin()
        self.ops.append(op)
        return op

    def all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        return self._boundary(
            lambda: Collective("all_reduce", group, t)).tensor

    def broadcast(self, t: torch.Tensor, group) -> torch.Tensor:
        return self._boundary(
            lambda: Collective("broadcast", group, t)).tensor

    def all_gather(self, t: torch.Tensor, dim: int, group) -> torch.Tensor:
        return self._boundary(lambda: Collective.gather(t, dim, group)).out


def agree(failed: bool, plan: Optional[Sequence[Collective]] = None,
          n_graphs: int = 0) -> None:
    """One all-reduce over every rank. Where any rank ``failed``, raises
    on every other rank (the failed rank raises its own error); with
    ``plan``, raises on every rank where the ranks' graph counts or
    collectives differ."""
    code = zlib.crc32(repr([op.signature() for op in plan or ()]).encode())
    dev = ("cpu" if dist.get_backend() == "gloo"
           else torch.device("cuda", torch.cuda.current_device()))
    t = torch.tensor([int(failed), n_graphs, code, -n_graphs, -code],
                     dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)  # max, and -min
    failed_any, hi_n, hi_code, lo_n, lo_code = t.tolist()
    if failed:  # the caller raises its own error
        return
    if failed_any:
        raise RuntimeError("a sharded program failed on another rank")
    if plan is not None and (hi_n != -lo_n or hi_code != -lo_code):
        raise RuntimeError(
            f"a sharded program differs across ranks: {n_graphs} graphs "
            f"here, {-lo_n}-{hi_n} on the ranks; collectives "
            f"{[op.signature() for op in plan]}")


class SegmentedProgram(Program):
    """One mesh rank's function of static inputs, then an all-gather of
    its output's rows over ``gather`` (the ``data`` group; None: none),
    as CUDA graphs between the collectives on the card.

    The function's collectives (``collectives.all_reduce_``,
    ``broadcast_`` and ``all_gather_dim``) split it into segments. On the
    card the first call

    1. runs the function eagerly on a side stream, its collectives with
       it (:meth:`Program._warm`; every rank does);
    2. captures it in one pass: each collective ends the graph being
       captured and begins the next in the pool, and is recorded, not
       run; the tensors it works on are static from then on (an
       all-reduce sums a product's fresh output in place; an all-gather's
       output is allocated between the graphs, outside the pool);
    3. checks, with one all-reduce over every rank, that no rank's capture
       raised and that every rank has the same graphs and collectives,
       else raises on every rank;
    4. replays: graph 1, collective 1, graph 2, ..., and last the
       all-gather over ``data`` into :attr:`output`, a buffer the program
       owns.

    Every later call stages and replays. A replay that raises on a rank
    takes part in its remaining collectives with zeros and raises after
    one all-reduce of a failure flag, which raises on its peers too.

    On the CPU nothing is captured: the function runs eagerly, and the
    first call records its collectives (:attr:`plan`) and checks them
    across ranks as the card does. :attr:`collective_s` sums the host
    seconds that the replays' collectives and checks took."""

    # whose collectives the capture records: this thread's (a forward), or
    # every thread's, in relaxed mode (a train step: :class:`_Segments`)
    every_thread = False

    def __init__(self, fn: Callable[..., torch.Tensor],
                 inputs: Dict[str, torch.Tensor], pool=None,
                 counters: Sequence = COUNTERS, *, gather=None):
        super().__init__(fn, inputs, pool, counters)
        self.gather = gather
        self.graphs: list = []
        # the collectives in order, the all-gather over data last
        self.plan: Optional[List[Collective]] = None
        self.collective_s = 0.0

    def _plan(self, rec: _Segments, out: torch.Tensor) -> List[Collective]:
        if self.gather is None:
            self.output = out
            return rec.ops
        final = Collective.gather(out, 0, self.gather)
        self.output = final.out
        return rec.ops + [final]

    def __call__(self, **arrays: np.ndarray) -> torch.Tensor:
        with self._phase("dispatch.stage"):
            self.stage(arrays)
        if self.device.type != "cuda":
            with self._phase("dispatch.replay"):
                self._run_eagerly()
        else:
            if self.plan is None:
                with self._phase("dispatch.capture"):
                    self._capture()
            with self._phase("dispatch.replay"):
                self.replay()
        return self.output

    def _run_eagerly(self) -> None:
        rec = _Segments()
        with recording(rec, self.every_thread):
            out = self.fn(**self.inputs)
        plan = self._plan(rec, out)
        if self.gather is not None:
            plan[-1].run()
        if self.plan is None:
            agree(False, plan, 1)
            self.plan = plan

    def _record(self) -> None:
        """Capture the function's segments (it runs nothing), then check
        them across ranks."""
        torch.cuda.synchronize(self.device)  # the warm run's collectives
        rec = _Segments(self.pool, card=True, relaxed=self.every_thread)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        got: dict = {}

        def capture():
            with torch.cuda.stream(side):
                try:
                    rec.begin()
                    with recording(rec, self.every_thread):
                        out = self.fn(**self.inputs)
                    rec.end()
                    got["out"] = out
                except Exception as e:  # raised below, on every rank
                    rec.abandon()
                    got["error"] = e
        self.launches = capture_counted(self.counters, capture)
        torch.cuda.current_stream(self.device).wait_stream(side)
        error = got.get("error")
        plan = [] if error else self._plan(rec, got["out"])
        agree(error is not None, plan, len(rec.graphs))
        if error is not None:
            raise error
        self.graphs, self.plan = rec.graphs, plan

    def replay(self) -> None:
        """Run graph, collective, graph, ... on the static inputs as they
        are; the all-gather over ``data`` last."""
        error = None
        for graph, op in itertools.zip_longest(self.graphs, self.plan):
            if graph is not None and error is None:
                try:
                    graph.replay()
                except Exception as e:  # raised below, on every rank
                    error = e
            if op is not None:
                t0 = time.perf_counter()
                if error is None:
                    op.run()
                else:
                    op.stand_in()
                self.collective_s += time.perf_counter() - t0
        if self.plan:
            t0 = time.perf_counter()
            agree(error is not None)
            self.collective_s += time.perf_counter() - t0
        if error is not None:
            raise error
        add_launches(self.counters, self.launches)


class TrainProgram(Program):
    """One train step of static inputs, as a CUDA graph on the card:
    bert_tpu's ``jax.jit(train_step)`` (bert_tpu/train.py:128).

    ``fn(**inputs)`` runs one step of ``model``'s parameters and their
    optimizer ``opt`` from gradients set to None (forward, backward,
    ``opt.step()``) and returns its metrics. Every call is a real step;
    none is thrown away. On the card

    1. the first call sets the gradients to None and runs ``fn`` eagerly
       on a side stream: that loads cuBLAS's handles (this thread's and
       autograd's), autograd's accumulators and the optimizer's state;
    2. the second sets the gradients to None and captures ``fn``: the
       backward allocates the gradients from the graph's pool, and those
       are the program's gradients from then on (it keeps them); then it
       replays;
    3. every later call replays, and sets no gradient to None.

    The graph reads and writes the parameters, the optimizer's moments
    and its step counts (a capturable optimizer keeps them on the card)
    where they were at the capture: :meth:`current` says whether they
    still are. After a replay each parameter's ``.grad`` is the program's
    gradient. A step's metrics are overwritten by the next replay. On the
    CPU every call sets the gradients to None and runs ``fn`` eagerly.
    The program keeps ``model`` and ``opt`` alive, so a table keyed by
    their ids never meets another state under the same key."""

    def __init__(self, fn: Callable[..., Tuple[torch.Tensor, ...]],
                 inputs: Dict[str, torch.Tensor], pool=None, *, model,
                 opt: torch.optim.Optimizer, counters: Sequence = COUNTERS):
        super().__init__(fn, inputs, pool, counters)
        self.model = model
        self.params = list(model.parameters())
        self.opt = opt
        self.steps = 0
        self.bound: Optional[List[torch.Tensor]] = None
        self.grads: Optional[List[torch.Tensor]] = None

    def binding(self) -> List[torch.Tensor]:
        """What a replay works on in place: each parameter and each
        tensor of its optimizer state."""
        out = list(self.params)
        for p in self.params:
            st = self.opt.state.get(p, {})
            out += [st[k] for k in sorted(st)]
        return out

    def current(self) -> bool:
        """Whether the state's tensors are still the captured ones (True
        before the capture). The program keeps the captured tensors, so
        no other tensor can take their memory."""
        if self.bound is None:
            return True
        now = self.binding()
        return len(now) == len(self.bound) and all(
            a.data_ptr() == b.data_ptr() for a, b in zip(now, self.bound))

    def __call__(self, **arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
        self.stage(arrays)
        card = self.device.type == "cuda"
        if card and self.steps:
            if self.bound is None:  # not captured yet
                self.opt.zero_grad(set_to_none=True)
                self._record()
                self.grads = [p.grad for p in self.params]
                self.bound = self.binding()
            self.replay()
            for p, g in zip(self.params, self.grads):
                p.grad = g
        else:
            self.opt.zero_grad(set_to_none=True)
            if card:
                self._warm()
            else:  # nothing is captured
                self._run_eagerly()
        self.steps += 1
        return self.output


class SegmentedTrainProgram(TrainProgram, SegmentedProgram):
    """One mesh rank's train step of static inputs: bert_tpu's GSPMD
    ``jax.jit(step_fn, in_shardings=...)`` (bert_tpu/train.py:201-206),
    as CUDA graphs between the step's collectives on the card.

    :class:`TrainProgram`'s lifecycle: the first call sets the gradients
    to None and runs the step eagerly on a side stream, its collectives
    with it on every rank; the second sets them to None and captures the
    step in one pass that runs nothing (:class:`SegmentedProgram`'s
    capture: each collective ends a graph, is recorded and begins the
    next; the backward allocates the gradients from the pool, and they
    are the program's from then on), checks the plan across ranks, and
    replays; every later call replays: graph, collective, ..., graph, the
    optimizer's update in the last, then a check of a failure flag. A
    replay that raises on a rank raises on every rank.

    The step's collectives, in the order it issues them: *g* after each
    row-parallel product of both forwards, each side's row all-gather
    over ``data``, then in the backward *g* again in each layer's remat
    recompute and *f*'s all-reduce at each column-parallel input, then
    each gradient summed over ``data`` and each replicated leaf's
    broadcast over ``model``, then the sharded leaves' squared norm
    summed over ``model``. On the card autograd issues the backward's
    from its device thread: the capture takes every thread's collectives
    and captures in relaxed mode (:class:`_Segments`), and the replay
    runs them all from the caller's thread. On the CPU nothing is
    captured: the step runs eagerly with the recorder set, and the first
    call checks the plan across ranks."""

    every_thread = True

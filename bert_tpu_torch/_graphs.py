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

A :class:`TrainProgram` is the trainer's counterpart of bert_tpu's
jitted train step (``jax.jit(train_step)``, bert_tpu/train.py:128): its
function is a whole step, forward, backward and optimizer update, whose
every call is a real step. Its first runs eagerly, its second is captured
and replayed, and the graph is bound to the parameters and optimizer
state it was captured on (the class says how).

The kernel wrappers count their launches in Python (``<wrapper>.launches``),
and a replay runs no Python. :func:`capture_counted` therefore takes back
what the capture counted and :meth:`Program.replay` adds it again, so a
counter keeps meaning "kernels the card ran": the eager warm-up run
counts, the capture does not, and each replay counts once.
"""

from __future__ import annotations

from typing import (Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .ops.attention import multi_head_attention
from .ops.fused_attention import fused_qkv_attention
from .ops.int8_matmul import (int8_matmul, int8_matmul_gelu,
                              quantize_activations_i8)
from .ops.layer_norm import fused_layer_norm, fused_layer_norm_codes
from .ops.q4_matmul import q4_matmul

# every kernel wrapper's launch counter
COUNTERS = (q4_matmul, fused_layer_norm, fused_layer_norm_codes,
            fused_qkv_attention, multi_head_attention, int8_matmul,
            int8_matmul_gelu, quantize_activations_i8)


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

    def __call__(self, **arrays: np.ndarray) -> torch.Tensor:
        self.stage(arrays)
        if self.device.type != "cuda":  # nothing is captured
            self.output = self.fn(**self.inputs)
            return self.output
        if self.graph is None:
            self._capture()
        self.replay()
        return self.output

    def current(self) -> bool:
        """Whether the tensors the program works on are still the ones it
        was made for (a forward program's inputs are its own: always)."""
        return True

    def _capture(self) -> None:
        self._warm()
        self._record()

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
    memory pool on the card."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = (torch.cuda.graph_pool_handle()
                     if device.type == "cuda" else None)
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
        return prog


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
            if self.graph is None:
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
                self.output = self.fn(**self.inputs)
        self.steps += 1
        return self.output

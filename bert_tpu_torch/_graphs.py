"""The engine's compiled programs: one CUDA graph per batch shape.

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

The kernel wrappers count their launches in Python (``<wrapper>.launches``),
and a replay runs no Python. :func:`capture_counted` therefore takes back
what the capture counted and :meth:`Program.replay` adds it again, so a
counter keeps meaning "kernels the card ran": the eager warm-up run
counts, the capture does not, and each replay counts once.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Optional, Sequence

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

    def _capture(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.fn(**self.inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
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
            arrays: Dict[str, np.ndarray]) -> Program:
        """The program of ``key``, made for ``fn`` with static inputs
        shaped and typed as ``arrays`` the first time the key is asked
        for (captured at its first call)."""
        prog = self.table.get(key)
        if prog is None:
            inputs = {name: torch.tensor(a, device=self.device)  # a copy
                      for name, a in arrays.items()}
            prog = self.table[key] = Program(fn, inputs, self.pool)
        return prog

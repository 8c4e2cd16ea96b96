"""The mixture-of-experts layer's ops: routing, the grouped Q4_0 expert
product, and the fixed-order combine.

The kernels are ``bert_tpu_torch/csrc/moe.cu``; they replace no TPU kernel
(the JAX package has no experts), and the source says what bounds them and
how their design copes. The whole layer stays on the device: the counts,
offsets and tiles of the sorted rows are device tensors that no op reads
back, so a batch shape is one CUDA graph.

- :func:`moe_route`: top-k of the softmax over the router's f32 logits
  [M, E] (greedy, descending, ties to the lower expert, weights times the
  routed scale), then a stable counting sort of the M·k (token, choice)
  pairs by expert: a :class:`Routing`.
- :func:`expert_matmul`: the sorted rows' products with their experts'
  Q4_0 weights (a :class:`~bert_tpu_torch.quant.QuantTensor` whose leaves
  lead with the expert: packed [E, K/2, N], scales [E, K/32, N]). With
  ``gather`` the rows are the tokens' rows of x through the sorted order
  (gate and up), else x's rows in place (down). ``swiglu`` takes a weight
  whose columns interleave gate and up in runs of 8 (:func:`swiglu_order`)
  and writes silu(gate)·up, [R, N/2]. One launch a product.
- :func:`moe_combine`: ``shared + Σ_j w[t, j] · y[pos(t, j)]`` in f32, the
  shared experts' product first, then the choices in order.

Each has a plain version (``*_plain``) in the same arithmetic order. The
plain expert product walks the experts over their rows; on a CPU tensor it
reads the counts, on a CUDA one (``use_kernels=False``) it computes every
expert over every row and keeps each row's own, so that it never
synchronises with the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels
from ..quant import QuantTensor
from .common import Count, counted
from .q4_matmul import q4_matmul_plain

BLOCK_M = 64  # the grouped product's rows a tile (csrc/moe.cu)
RUN = 8  # gate and up columns interleave in runs of RUN


class Routing(NamedTuple):
    """One MoE layer's routing of M tokens, k choices each; R = M·k."""
    topi: torch.Tensor        # [M, k] int32 expert of each choice
    topw: torch.Tensor        # [M, k] f32 weight of each choice
    sorted_tok: torch.Tensor  # [R] int32 token of each sorted row
    slot_pos: torch.Tensor    # [M·k] int32 sorted row of each choice
    counts: torch.Tensor      # [E] int32 rows of each expert
    tiles: Optional[tuple]    # (tile_e, tile_r0, tile_r1, n_tiles): kernels


def swiglu_order(width: int) -> np.ndarray:
    """The order of the rows of ``[gate; up]`` ([2·width, K], torch layout)
    that interleaves them in runs of :data:`RUN`: gate 0-7, up 0-7, gate
    8-15, ... A permutation of output rows moves whole Q4 groups, so it is
    bit-exact before or after quantizing."""
    if width % RUN:
        raise ValueError(f"swiglu_order: width {width} not a multiple of "
                         f"{RUN}")
    runs = np.arange(2 * width).reshape(2, width // RUN, RUN)
    return runs.transpose(1, 0, 2).reshape(-1)


def max_tiles(rows: int, n_experts: int) -> int:
    """The most tiles of :data:`BLOCK_M` sorted rows ``rows`` can make over
    ``n_experts`` experts: the grouped product's grid."""
    return -(-rows // BLOCK_M) + n_experts


def moe_route_plain(logits: torch.Tensor, top_k: int, scaling: float,
                    acc: Optional[torch.Tensor] = None) -> Routing:
    """Plain version: ``torch.softmax`` and ``torch.topk`` (descending),
    then a stable argsort of the choices by expert; ``acc`` [E] int64
    (optional) += the counts."""
    m, e = logits.shape
    p = torch.softmax(logits.float(), dim=-1)
    topw, topi = torch.topk(p, top_k, dim=-1)
    flat = topi.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(e, dtype=torch.int64, device=logits.device)
    counts.index_add_(0, flat, torch.ones_like(flat))
    if acc is not None:
        acc += counts
    slot_pos = torch.empty_like(order)
    slot_pos[order] = torch.arange(order.numel(), device=order.device)
    return Routing(topi.to(torch.int32), topw * scaling,
                   (order // top_k).to(torch.int32),
                   slot_pos.to(torch.int32), counts.to(torch.int32), None)


@counted
def moe_route(logits: torch.Tensor, top_k: int, scaling: float = 1.0,
              acc: Optional[torch.Tensor] = None) -> Routing:
    """Route M tokens: ``logits`` [M, E] f32 → a :class:`Routing`, with
    ``acc`` [E] int64 (optional) += each expert's rows. CPU tensors take
    :func:`moe_route_plain`; CUDA tensors launch ``moe_topk`` and
    ``moe_sort`` (two launches) or raise."""
    if logits.device.type == "cpu":
        return moe_route_plain(logits, top_k, scaling, acc)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_route: unsupported device {logits.device}")
    m, e = logits.shape
    if logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError("moe_route: logits must be contiguous f32 [M, E]")
    if not 0 < top_k <= e <= 64:
        raise ValueError(f"moe_route: {e} experts, top {top_k}: the kernel "
                         "takes 1 <= k <= E <= 64")
    if acc is not None and (acc.shape != (e,) or acc.dtype != torch.int64
                            or acc.device != logits.device
                            or not acc.is_contiguous()):
        raise ValueError(f"moe_route: acc must be contiguous int64 [{e}]")
    dev = logits.device
    r = m * top_k
    i32 = dict(dtype=torch.int32, device=dev)
    topi = torch.empty((m, top_k), **i32)
    topw = torch.empty((m, top_k), dtype=torch.float32, device=dev)
    sorted_tok = torch.empty(r, **i32)
    slot_pos = torch.empty(r, **i32)
    counts = torch.empty(e, **i32)
    n = max_tiles(r, e)
    tiles = (torch.empty(n, **i32), torch.empty(n, **i32),
             torch.empty(n, **i32), torch.empty(1, **i32))
    if m == 0:
        counts.zero_()
        tiles[3].zero_()
        return Routing(topi, topw, sorted_tok, slot_pos, counts, tiles)
    lib = _kernels.library("moe")
    stream = _kernels.stream_of(logits)
    with torch.cuda.device(dev):
        rc = lib.moe_topk(logits.data_ptr(), m, e, top_k, float(scaling),
                          topi.data_ptr(), topw.data_ptr(), stream)
        _kernels.check(rc, "moe_topk")
        rc = lib.moe_sort(topi.data_ptr(), r, top_k, e, sorted_tok.data_ptr(),
                          slot_pos.data_ptr(), counts.data_ptr(),
                          *(t.data_ptr() for t in tiles),
                          None if acc is None else acc.data_ptr(), stream)
        _kernels.check(rc, "moe_sort")
    moe_route.launches += 2
    return Routing(topi, topw, sorted_tok, slot_pos, counts, tiles)


def _expert(qt: QuantTensor, e: int) -> QuantTensor:
    return QuantTensor(packed=qt.packed[e], scales=qt.scales[e])


def _swiglu(y: torch.Tensor) -> torch.Tensor:
    """silu(gate)·up of a product whose columns interleave gate and up in
    runs of RUN, in y's dtype (f32)."""
    rows, n = y.shape
    y4 = y.reshape(rows, n // (2 * RUN), 2, RUN)
    g = y4[:, :, 0].reshape(rows, n // 2)
    u = y4[:, :, 1].reshape(rows, n // 2)
    return F.silu(g) * u


def expert_matmul_plain(x: torch.Tensor, qt: QuantTensor, routing: Routing,
                        *, gather: bool, swiglu: bool) -> torch.Tensor:
    """Plain version: each expert's rows (in the sorted order) times its
    dequantized weight (``q4_matmul_plain``), in f32, SwiGLU in f32, then
    rounded to x's dtype."""
    xs = x[routing.sorted_tok.long()] if gather else x
    rows = routing.sorted_tok.numel()
    n_out = qt.packed.shape[-1] // (2 if swiglu else 1)
    out = torch.zeros((rows, n_out), dtype=torch.float32, device=x.device)
    n_exp = qt.packed.shape[0]
    if x.device.type == "cpu":
        ends = torch.cumsum(routing.counts.long(), 0).tolist()
        for e in range(n_exp):
            lo, hi = (ends[e - 1] if e else 0), ends[e]
            if hi > lo:
                y = q4_matmul_plain(xs[lo:hi], _expert(qt, e))
                out[lo:hi] = _swiglu(y) if swiglu else y
    else:
        ends = torch.cumsum(routing.counts.long(), 0)
        row = torch.arange(rows, device=x.device)
        owner = torch.searchsorted(ends, row, right=True)
        for e in range(n_exp):
            y = q4_matmul_plain(xs, _expert(qt, e))
            y = _swiglu(y) if swiglu else y
            out = torch.where((owner == e)[:, None], y, out)
    return out.to(x.dtype)


@counted
def expert_matmul(x: torch.Tensor, qt: QuantTensor, routing: Routing, *,
                  gather: bool, swiglu: bool) -> torch.Tensor:
    """The grouped Q4_0 product of the routing's sorted rows → [R, N] (or
    [R, N/2] with ``swiglu``) in x's dtype. CPU tensors take
    :func:`expert_matmul_plain`; CUDA tensors (bf16, K % 64 == 0, N % 64
    == 0) launch the kernel once or raise."""
    if x.device.type == "cpu":
        return expert_matmul_plain(x, qt, routing, gather=gather,
                                   swiglu=swiglu)
    if x.device.type != "cuda":
        raise ValueError(f"expert_matmul: unsupported device {x.device}")
    if routing.tiles is None:
        raise ValueError("expert_matmul: the routing has no tile table "
                         "(route with moe_route on the card)")
    if x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("expert_matmul: x must be contiguous bf16 [rows, K]")
    if qt.mins is not None:
        raise ValueError("expert_matmul: the kernel takes Q4_0 weights")
    n_exp, half, n = qt.packed.shape
    k = 2 * half
    if (x.shape[1] != k or k % 64 or n % 64
            or tuple(qt.scales.shape) != (n_exp, k // 32, n)
            or qt.packed.dtype != torch.uint8
            or qt.scales.dtype != torch.float32
            or not (qt.packed.is_contiguous() and qt.scales.is_contiguous())):
        raise ValueError(f"expert_matmul: x {tuple(x.shape)} against "
                         f"packed {tuple(qt.packed.shape)}, scales "
                         f"{tuple(qt.scales.shape)}: K and N must be "
                         "multiples of 64")
    rows = routing.sorted_tok.numel()
    if not gather and x.shape[0] != rows:
        raise ValueError("expert_matmul: without gather x holds the sorted "
                         "rows")
    for name, t in (("x", x), ("packed", qt.packed), ("scales", qt.scales)):
        if t.data_ptr() % 16:
            raise ValueError(f"expert_matmul: {name} is not 16-byte aligned")
    n_out = n // 2 if swiglu else n
    out = torch.empty((rows, n_out), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    tile_e, tile_r0, tile_r1, n_tiles = routing.tiles
    with torch.cuda.device(x.device):
        rc = _kernels.library("moe").expert_q4_matmul_bf16(
            x.data_ptr(), k,
            routing.sorted_tok.data_ptr() if gather else None,
            qt.packed.data_ptr(), qt.scales.data_ptr(), tile_e.data_ptr(),
            tile_r0.data_ptr(), tile_r1.data_ptr(), n_tiles.data_ptr(),
            tile_e.numel(), out.data_ptr(), n_out, k, n, int(swiglu),
            _kernels.stream_of(x))
    _kernels.check(rc, "expert_q4_matmul_bf16")
    expert_matmul.launches += 1
    (expert_matmul.gate_up if swiglu else expert_matmul.down).launches += 1
    return out


def moe_combine_plain(shared: torch.Tensor, y: torch.Tensor,
                      routing: Routing) -> torch.Tensor:
    """Plain version: ``shared + w0·y[pos0] + w1·y[pos1] + ...`` in f32, in
    that order."""
    m, k = routing.topw.shape
    pos = routing.slot_pos.reshape(m, k).long()
    out = shared.float()
    for j in range(k):
        out = out + routing.topw[:, j, None] * y[pos[:, j]].float()
    return out


@counted
def moe_combine(shared: torch.Tensor, y: torch.Tensor,
                routing: Routing) -> torch.Tensor:
    """Each token's layer output [M, D] f32: the shared experts' product
    ``shared`` (f32) plus its choices' rows of ``y`` [R, D] weighted. CPU
    tensors take :func:`moe_combine_plain`; CUDA tensors launch the kernel
    or raise."""
    if shared.device.type == "cpu":
        return moe_combine_plain(shared, y, routing)
    if shared.device.type != "cuda":
        raise ValueError(f"moe_combine: unsupported device {shared.device}")
    m, d = shared.shape
    k = routing.topw.shape[1]
    if (shared.dtype != torch.float32 or y.dtype != torch.bfloat16
            or y.shape != (m * k, d) or d % 8
            or not (shared.is_contiguous() and y.is_contiguous())):
        raise ValueError(f"moe_combine: shared f32 [{m}, {d}] and y bf16 "
                         f"[{m * k}, {d}], contiguous, D % 8 == 0")
    out = torch.empty_like(shared)
    if m == 0:
        return out
    with torch.cuda.device(shared.device):
        rc = _kernels.library("moe").moe_combine(
            shared.data_ptr(), y.data_ptr(), routing.topw.data_ptr(),
            routing.slot_pos.data_ptr(), out.data_ptr(), m, k, d,
            _kernels.stream_of(shared))
    _kernels.check(rc, "moe_combine")
    moe_combine.launches += 1
    return out


# of the grouped product's launches, the gate and up form's and the down's
expert_matmul.gate_up = counted(Count("expert_matmul.gate_up"))
expert_matmul.down = counted(Count("expert_matmul.down"))

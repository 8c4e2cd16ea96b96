"""Which dimension of each stacked parameter is split over ``model``, and
the host-side cut of a params tree into tensor-parallel shards.

Counterpart of ``bert_tpu/parallel/sharding.py``: Megatron-style tensor
parallelism.

  * column-parallel (split the OUT dim): the QKV projection and the FFN
    up-projection, and their biases — the QKV out dim is head-interleaved
    (params.py), so a contiguous shard holds whole heads;
  * row-parallel (split the IN dim): the attention-output and FFN-down
    projections — each rank holds a partial product, summed by one
    all-reduce per residual branch (two a layer, model.py);
  * replicated: embeddings, LayerNorms, row-parallel biases.

bert_tpu's PartitionSpec trees become one table, :func:`split_dim`: the
axis of a stacked leaf (``[L, K, N]`` weights, ``[L, N]`` biases) that is
cut, or None. The batch is cut along its rows (dim 0) over ``data``.

:func:`shard_params` cuts the HOST tree, before anything goes to a
device: each shard is then laid out for the device on its own
(``params_to_torch``), since the device layouts (the int8 weight's
``[N, Kp]`` with K padded to 32, the q4 kernel's N alignment) are not
slices of the whole. QuantTensor leaves (``packed[L, K//2, N]``,
``scales``/``mins[L, K//32, N]``) are cut like the weight they encode:
the group-local packing makes any K cut at 64-row granularity a valid
packed array, which :func:`check_tp_divisibility` demands.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops.int8_matmul import Int8Tensor
from ..quant import QuantTensor
from .collectives import all_gather_dim

# stacked layer weights: [L, K, N]
_COL_PARALLEL = {"qkv_w", "ff_i_w"}  # split N (out)
_ROW_PARALLEL = {"o_w", "ff_o_w"}  # split K (in)
_COL_BIAS = {"qkv_b", "ff_i_b"}  # [L, N] split N
BATCH_DIM = 0  # batch rows over ``data``


def split_dim(group: str, key: str) -> Optional[int]:
    """The axis of stacked leaf ``group/key`` split over ``model``, or None
    (replicated)."""
    if group != "layers":
        return None
    if key in _COL_PARALLEL:
        return 2
    if key in _ROW_PARALLEL:
        return 1
    if key in _COL_BIAS:
        return 1
    return None


def gather_leaf(group: str, key: str, t: torch.Tensor,
                tp_group) -> torch.Tensor:
    """``t`` (leaf ``group/key`` of a tensor-parallel shard, or a tensor
    of its shape: its gradient, an AdamW moment) whole: all-gathered over
    ``tp_group`` along its split axis, or as it is when the leaf is
    replicated or ``tp_group`` is None. A collective: every rank of
    ``tp_group`` calls it."""
    dim = split_dim(group, key)
    t = t.detach()
    return t if dim is None else all_gather_dim(t, dim, tp_group)


def check_tp_divisibility(config, tp: int, quantized: bool) -> None:
    """Validate that mesh TP size divides the model cleanly."""
    if config.n_head % tp:
        raise ValueError(f"n_head {config.n_head} % tp {tp} != 0")
    if config.n_intermediate % tp:
        raise ValueError(
            f"n_intermediate {config.n_intermediate} % tp {tp} != 0")
    if quantized and (config.n_embd // tp) % 64:
        raise ValueError(
            f"quantized TP needs n_embd/tp ({config.n_embd}/{tp}) to be a "
            "multiple of 64 (Q4 block granularity, cf. bert.cpp:638)"
        )
    if quantized and (config.n_intermediate // tp) % 64:
        # ff_o_w is row-parallel with contraction dim n_intermediate: its
        # packed Q4 shard must also cut on 64-row group boundaries
        raise ValueError(
            f"quantized TP needs n_intermediate/tp "
            f"({config.n_intermediate}/{tp}) to be a multiple of 64 "
            "(Q4 block granularity of the row-parallel FFN-down shard)"
        )


def _cut(a, dim: Optional[int], tp: int, rank: int):
    if dim is None or tp == 1:
        return a
    return np.split(np.asarray(a), tp, axis=dim)[rank]


def shard_leaf(v, dim: Optional[int], tp: int, rank: int):
    """Model-axis shard ``rank`` of ``tp`` of one host leaf cut along
    ``dim``: an array, a QuantTensor (its packed codes, scales and mins
    along the same axis), or an Int8Tensor, whose per-out-column
    ``scale[L, N]`` is cut with N under column parallelism and replicated
    under row parallelism."""
    if isinstance(v, QuantTensor):
        return QuantTensor(packed=_cut(v.packed, dim, tp, rank),
                           scales=_cut(v.scales, dim, tp, rank),
                           mins=None if v.mins is None
                           else _cut(v.mins, dim, tp, rank))
    if isinstance(v, Int8Tensor):
        return Int8Tensor(w_i8=_cut(v.w_i8, dim, tp, rank),
                          scale=_cut(v.scale, 1 if dim == 2 else None, tp,
                                     rank))
    return _cut(v, dim, tp, rank)


def shard_params(host_params: Dict[str, Dict[str, Any]], tp: int,
                 rank: int) -> Dict[str, Dict[str, Any]]:
    """Model-axis shard ``rank`` (0 ≤ rank < tp) of a host params tree
    (numpy arrays, QuantTensors, Int8Tensors); replicated leaves are
    shared, not copied."""
    if not 0 <= rank < tp:
        raise ValueError(f"model rank {rank} outside tp {tp}")
    return {group: {k: shard_leaf(v, split_dim(group, k), tp, rank)
                    for k, v in sub.items()}
            for group, sub in host_params.items()}

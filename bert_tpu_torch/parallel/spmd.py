"""SPMD execution: this rank's parameter shard on its device, and the
sharded encode.

Counterpart of ``bert_tpu/parallel/spmd.py``. bert_tpu runs the encoder
under ``shard_map`` with its two psums a layer written out, so that the
Pallas kernels see per-device shards; here every rank runs the encoder on
its own shard and its own batch rows, with the two all-reduces over
``model`` in model.py and one all-gather over ``data`` at the end, and
the kernels run on the shard shapes. bert_tpu jits that shard_map once per
batch shape; here each batch shape is one ``_graphs.SegmentedProgram``,
on the card CUDA graphs between the collectives.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..quant import QuantTensor
from . import sharding
from .mesh import (DATA_AXIS, MODEL_AXIS, axis_group, axis_index, axis_size,
                   local_rows, rank_device)


def shard_params(mesh, params, *, dtype: torch.dtype = torch.float32):
    """This rank's ``model``-axis shard of a host params tree, on its
    device (``params_to_torch`` of :func:`sharding.shard_params`;
    ``dtype`` as there)."""
    from ..params import params_to_torch

    host = sharding.shard_params(params, axis_size(mesh, MODEL_AXIS),
                                 axis_index(mesh, MODEL_AXIS))
    return params_to_torch(host, device=rank_device(mesh), dtype=dtype)


def make_sharded_encode_fn(
    mesh,
    config,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    use_kernels: Optional[bool] = None,
    pooling: str = "mean",
    params_example=None,
):
    """(params, ids, mask) → [B, n_embd] f32 on every rank; the returned
    function's ``programs`` is its program table.

    ``params`` is :func:`shard_params`'s shard; ``ids``/``mask`` the
    whole [B, T] batch (numpy or tensors), the same on every rank. Each
    rank runs its ``data``-axis rows through its shard (tensor-parallel
    over ``model``) and the rows are all-gathered over ``data``: one
    program per (B, T) and params tree, captured at its first batch
    (``_graphs.SegmentedProgram``). ``compute_dtype`` defaults to bf16 on
    the card and f32 on the CPU. ``params_example`` (the host tree), when
    given, is checked for tensor-parallel divisibility, quantized or not.
    """
    # model.py and _graphs.py import this package (its collectives):
    # import them here
    from .._graphs import Programs, SegmentedProgram
    from ..model import BertModel, bert_forward

    dev = rank_device(mesh)
    if compute_dtype is None:
        compute_dtype = (torch.bfloat16 if dev.type == "cuda"
                         else torch.float32)
    tp = axis_size(mesh, MODEL_AXIS)
    if params_example is not None and tp > 1:
        sharding.check_tp_divisibility(
            config, tp, quantized=any(
                isinstance(v, QuantTensor)
                for v in params_example["layers"].values()))
    tp_group = axis_group(mesh, MODEL_AXIS)
    program = functools.partial(SegmentedProgram,
                                gather=axis_group(mesh, DATA_AXIS))
    programs = Programs(dev)
    # id(params) → (params, its model): the tree stays alive, so its id
    # keys its programs and no other tree's
    models = {}

    def as_array(a, dtype):
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        return np.asarray(a, dtype=dtype)

    @torch.inference_mode()
    def encode(params, ids, mask):
        rows = local_rows(mesh, ids.shape[0])
        if id(params) not in models:
            models[id(params)] = (params,
                                  BertModel(params, config, tp_group).eval())
        model = models[id(params)][1]

        def forward(ids, mask):
            return bert_forward(model, ids, mask,
                                compute_dtype=compute_dtype,
                                use_kernels=use_kernels, pooling=pooling)
        arrays = {"ids": as_array(ids, np.int64)[rows],
                  "mask": as_array(mask, np.float32)[rows]}
        prog = programs.get((*ids.shape, id(params)), forward, arrays,
                            program)
        # a copy: the program's output is overwritten by its next call
        return prog(**arrays).clone()

    encode.programs = programs
    return encode

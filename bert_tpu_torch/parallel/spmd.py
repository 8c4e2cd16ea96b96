"""SPMD execution: this rank's parameter shard on its device, and the
sharded encode.

Counterpart of ``bert_tpu/parallel/spmd.py``. bert_tpu runs the encoder
under ``shard_map`` with its two psums a layer written out, so that the
Pallas kernels see per-device shards; here every rank runs the encoder on
its own shard and its own batch rows, with the two all-reduces over
``model`` in model.py and one all-gather over ``data`` at the end, and
the kernels run on the shard shapes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..quant import QuantTensor
from . import sharding
from .collectives import gather_rows
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
    """(params, ids, mask) → [B, n_embd] f32 on every rank.

    ``params`` is :func:`shard_params`'s shard; ``ids``/``mask`` the
    whole [B, T] batch (numpy or tensors), the same on every rank. Each
    rank runs its ``data``-axis rows through its shard (tensor-parallel
    over ``model``) and the rows are all-gathered over ``data``.
    ``compute_dtype`` defaults to bf16 on the card and f32 on the CPU.
    ``params_example`` (the host tree), when given, is checked for
    tensor-parallel divisibility, quantized or not.
    """
    # model.py imports this package (its collectives): import it here
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
    dp_group = axis_group(mesh, DATA_AXIS)
    built = {}

    def as_tensor(a, dtype):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        return t.to(dev, dtype)

    @torch.inference_mode()
    def encode(params, ids, mask):
        rows = local_rows(mesh, ids.shape[0])
        if built.get("params") is not params:
            built.update(params=params,
                         model=BertModel(params, config, tp_group).eval())
        emb = bert_forward(built["model"], as_tensor(ids[rows], torch.int64),
                           as_tensor(mask[rows], torch.float32),
                           compute_dtype=compute_dtype,
                           use_kernels=use_kernels, pooling=pooling)
        return gather_rows(emb, dp_group)

    return encode

"""The collectives of sharded execution, and Megatron's autograd
operators.

bert_tpu writes its collectives inside ``shard_map`` (``jax.lax.psum``)
and lets GSPMD differentiate them; here they are ``torch.distributed``
calls on the mesh's subgroups, and their gradients are written out:

* :func:`copy_to_model` (Megatron's *f*): identity forward, all-reduce
  over ``model`` backward — at the input of each column-parallel product;
* :func:`reduce_from_model` (*g*): all-reduce forward, identity backward —
  after each row-parallel product. ``torch.distributed.nn``'s all-reduce
  is not *g*: its backward all-reduces again, which multiplies the
  gradient of a replicated consumer by tp;
* :func:`gather_rows`: all-gather of batch rows over ``data`` whose
  backward keeps this rank's rows and sums nothing, for a loss that every
  rank computes alike on the whole batch.

A group of None means one rank: every function is then the identity.
When ranks share one card the backend is gloo, which takes CUDA tensors
for every collective here (it stages them through host memory itself),
so nothing is staged in this module.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    if group is None:
        return t
    dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of ``group``'s first rank, in place on every rank; returns
    it."""
    if group is None:
        return t
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in rank
    order."""
    if group is None:
        return t
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[0]
        return all_gather_dim(x, 0, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Megatron's *f*: ``x`` as is; its gradient summed over ``group``."""
    if group is None or not _tracked(x):
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Optional[object]
                      ) -> torch.Tensor:
    """Megatron's *g*: ``x`` summed over ``group``, in ``x``'s dtype; its
    gradient passed through. ``x`` (a product's fresh output) is summed in
    place when autograd does not track it."""
    if group is None:
        return x
    if not _tracked(x):
        return all_reduce_(x, group)
    return _ReduceFromModel.apply(x, group)


def gather_rows(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """All-gather of ``x``'s rows over ``group``; the backward takes this
    rank's rows of the gradient and sums nothing over ranks."""
    if group is None:
        return x
    if not _tracked(x):
        return all_gather_dim(x, 0, group)
    return _GatherRows.apply(x, group)

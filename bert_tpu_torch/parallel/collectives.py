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

A sharded program (``_graphs.SegmentedProgram``) is captured in segments
that end at each collective, each kept as a :class:`Collective` to run
between the segments' replays. For the length of a capture the program
sets a recorder (:func:`recording`); :func:`all_reduce_`,
:func:`broadcast_` and :func:`all_gather_dim` then hand their collective
to it instead of running it (``recorder.all_reduce(t, group)`` /
``recorder.broadcast(t, group)`` / ``recorder.all_gather(t, dim,
group)``, each returning what the collective returns). With no recorder
set they run as they always do.

A forward's recorder is this thread's. A train step's
(``_graphs.SegmentedTrainProgram``) is the process's: on the card
autograd runs the backward on a device thread of its own, so the remat
recompute's *g* and *f*'s backward are issued there, while the step's
thread waits inside ``loss.backward()``. ``recording(rec,
every_thread=True)`` sets the recorder for every thread of the process
for the length of the capture: it takes a lock first, so no other such
capture claims it meanwhile, and gives it back on exit, a raise
included. A thread's own recorder comes first.
"""

from __future__ import annotations

import contextlib
import threading
import types
from typing import Optional

import torch
import torch.distributed as dist


class _Recording(threading.local):
    recorder = None


_recording = _Recording()
# every thread's recorder for the length of a train capture, and its lock
_shared = types.SimpleNamespace(recorder=None)
_shared_lock = threading.Lock()


@contextlib.contextmanager
def recording(recorder, every_thread: bool = False):
    """Within the block this thread's collectives go to ``recorder``;
    with ``every_thread``, every thread's (one such block at a time: the
    next waits for the lock)."""
    if every_thread:
        with _shared_lock:
            _shared.recorder = recorder
            try:
                yield recorder
            finally:
                _shared.recorder = None
        return
    prev, _recording.recorder = _recording.recorder, recorder
    try:
        yield recorder
    finally:
        _recording.recorder = prev


def _recorder():
    """The recorder that takes this thread's collectives, or None."""
    mine = _recording.recorder
    return mine if mine is not None else _shared.recorder


class Collective:
    """One collective: ``tensor`` summed over ``group`` in place
    (``"all_reduce"``), the ``tensor`` of ``group``'s first rank put in
    place on every rank (``"broadcast"``), or every rank's ``tensor`` of
    ``group`` gathered into ``out`` along ``dim`` in rank order
    (``"all_gather"``). A sharded
    program keeps one for each of its collectives; on the card both
    tensors are static, where its graphs write and read them."""

    def __init__(self, op: str, group, tensor: torch.Tensor,
                 out: Optional[torch.Tensor] = None, dim: int = 0):
        self.op, self.group, self.tensor = op, group, tensor
        self.out, self.dim = out, dim

    @classmethod
    def gather(cls, tensor: torch.Tensor, dim: int, group) -> "Collective":
        """An all-gather of ``tensor`` with its output allocated."""
        shape = list(tensor.shape)
        shape[dim] *= dist.get_world_size(group)
        return cls("all_gather", group, tensor,
                   torch.empty(shape, dtype=tensor.dtype,
                               device=tensor.device), dim)

    def run(self) -> None:
        # detached: a train program's tensors are autograd's outputs (an
        # in-place write into the gathered rows' views would be refused)
        t = self.tensor.detach()
        if self.op == "all_reduce":
            dist.all_reduce(t, group=self.group)
            return
        if self.op == "broadcast":
            dist.broadcast(t, src=dist.get_global_rank(self.group, 0),
                           group=self.group)
            return
        n = dist.get_world_size(self.group)
        out = self.out.detach()
        if self.dim == 0:  # the output's row blocks are contiguous views
            dist.all_gather(list(out.chunk(n)), t, group=self.group)
            return
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self.group)
        torch.cat(parts, dim=self.dim, out=out)

    def stand_in(self) -> None:
        """Take part in this collective with zeros on the host: a rank
        whose replay failed keeps its peers' collectives whole (gloo)."""
        t = torch.zeros(self.tensor.shape, dtype=self.tensor.dtype)
        if self.op == "all_reduce":
            dist.all_reduce(t, group=self.group)
        elif self.op == "broadcast":
            dist.broadcast(t, src=dist.get_global_rank(self.group, 0),
                           group=self.group)
        else:
            dist.all_gather([torch.empty_like(t) for _ in range(
                dist.get_world_size(self.group))], t, group=self.group)

    def signature(self) -> tuple:
        """What every rank's same collective has alike."""
        return (self.op, dist.get_world_size(self.group),
                tuple(self.tensor.shape), str(self.tensor.dtype), self.dim)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    if group is None:
        return t
    rec = _recorder()
    if rec is not None:
        return rec.all_reduce(t, group)
    dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of ``group``'s first rank, in place on every rank; returns
    it."""
    if group is None:
        return t
    rec = _recorder()
    if rec is not None:
        return rec.broadcast(t, group)
    Collective("broadcast", group, t).run()
    return t


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in rank
    order."""
    if group is None:
        return t
    src = t.contiguous()
    rec = _recorder()
    if rec is not None:
        return rec.all_gather(src, dim, group)
    op = Collective.gather(src, dim, group)
    op.run()
    return op.out


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

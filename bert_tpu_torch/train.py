"""Contrastive fine-tuning of the embedding model on one device.

Counterpart of ``bert_tpu/train.py`` (:class:`TrainState`,
:func:`_decay_mask`, :func:`make_optimizer`, :func:`init_train_state`,
:func:`info_nce_loss`, :func:`make_train_step`). Loss: symmetric
in-batch-negatives InfoNCE over L2-normalized sentence pairs. Optimizer:
AdamW with optax.adamw's defaults (β 0.9 / 0.999, ε 1e-8) and bert_tpu's
decay mask.

Torch's idiom changes two things and keeps the names. An optimizer is
built over the parameters it updates and holds their moments, so
:func:`make_optimizer` returns a spec (:class:`AdamW`) whose ``init``
builds the ``torch.optim.AdamW`` over a model, as optax's ``init`` builds
the state over a params tree; ``TrainState.params`` is the
:class:`~bert_tpu_torch.model.TrainableBertModel` and
``TrainState.opt_state`` that AdamW. And the step updates them in place:
it returns a TrainState over the same model and optimizer, one step on.

Training runs the plain PyTorch versions of every op
(``use_kernels=False``): the kernels have no backward, and bert_tpu's
training never runs a Pallas kernel either (its ``use_pallas=False``).
The tuned weights are served through the kernels. Only dense weights
train; quantize after fine-tuning.

:func:`make_sharded_train_step` is bert_tpu's GSPMD step in
``torch.distributed``'s idiom: each rank holds its Megatron shard of the
parameters and both AdamW moments (parallel/sharding.py), runs its
``data``-axis rows of the batch, and computes the InfoNCE loss over the
whole batch; gradients are summed over ``data``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .model import TrainableBertModel, bert_forward
from .parallel.collectives import all_reduce_, broadcast_, gather_rows
from .parallel.mesh import (DATA_AXIS, MODEL_AXIS, axis_group, axis_size,
                            local_rows, rank_device)
from .parallel.sharding import gather_leaf, shard_params, split_dim
from .params import BertConfig, params_to_numpy, params_to_torch

BETAS = (0.9, 0.999)  # optax.adamw's defaults
EPS = 1e-8


class TrainState(NamedTuple):
    params: TrainableBertModel
    opt_state: torch.optim.AdamW
    step: int
    mesh: Any = None  # the mesh of make_sharded_train_step's states


def _decay_mask(params) -> Dict[str, Dict[str, bool]]:
    """Standard BERT fine-tuning decay mask: weight matrices and embedding
    tables decay; LayerNorm scales/biases and projection biases do not.
    Keyed by NAME, not ndim: stacked layer leaves are all rank ≥ 2 here
    (biases are [L, D]), so the usual ndim<2 heuristic would decay
    everything."""
    emb_decay = ("word", "token_type", "position")
    return {
        "embeddings": {k: k in emb_decay for k in params["embeddings"]},
        "layers": {k: k.endswith("_w") for k in params["layers"]},
    }


@dataclass(frozen=True)
class AdamW:
    """What ``optax.adamw(learning_rate, weight_decay=...,
    mask=_decay_mask)`` is in bert_tpu: :meth:`init` builds the torch
    optimizer over a model's parameters, the masked-off ones in a group
    with no weight decay."""

    learning_rate: float = 2e-5
    weight_decay: float = 0.01

    def init(self, model: TrainableBertModel) -> torch.optim.AdamW:
        tree = model.tree()
        mask = _decay_mask(tree)
        decay, no_decay = [], []
        for group, sub in tree.items():
            for key, p in sub.items():
                (decay if mask[group][key] else no_decay).append(p)
        return torch.optim.AdamW(
            [{"params": decay, "weight_decay": self.weight_decay},
             {"params": no_decay, "weight_decay": 0.0}],
            lr=self.learning_rate, betas=BETAS, eps=EPS)

    def built(self, opt: torch.optim.AdamW) -> bool:
        """Whether ``opt`` was built by :meth:`init` of this spec."""
        return ([(g["lr"], g["betas"], g["eps"], g["weight_decay"])
                 for g in opt.param_groups]
                == [(self.learning_rate, BETAS, EPS, wd)
                    for wd in (self.weight_decay, 0.0)])


def make_optimizer(learning_rate: float = 2e-5,
                   weight_decay: float = 0.01) -> AdamW:
    return AdamW(learning_rate, weight_decay)


def init_train_state(params: TrainableBertModel,
                     optimizer: AdamW) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0)


def _tensor(a) -> torch.Tensor:
    """A tensor as is; an array (numpy, or anything np.asarray takes) as a
    tensor over a copy of it."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a))


def place_adam_state(opt: torch.optim.AdamW, params: TrainableBertModel,
                     mu: Mapping[str, Mapping[str, Any]],
                     nu: Mapping[str, Mapping[str, Any]],
                     count: int) -> None:
    """Put AdamW moments into ``opt``: ``mu`` / ``nu`` are trees keyed as
    ``params.tree()`` (arrays or tensors), ``count`` the number of steps
    taken (optax's ``count``; torch keeps one per parameter). The moments
    are placed as given, never re-initialized."""
    for group, sub in params.tree().items():
        for key, p in sub.items():
            m, v = (_tensor(t[group][key]) for t in (mu, nu))
            if m.shape != p.shape or v.shape != p.shape:
                raise ValueError(f"{group}/{key}: moments {tuple(m.shape)}, "
                                 f"{tuple(v.shape)} for a parameter "
                                 f"{tuple(p.shape)}")
            opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": m.to(p.device, p.dtype, copy=True),
                "exp_avg_sq": v.to(p.device, p.dtype, copy=True)}


def info_nce_loss(emb_a: torch.Tensor, emb_b: torch.Tensor,
                  temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE with in-batch negatives over L2-normed embeddings."""
    logits = emb_a @ emb_b.T / temperature  # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))


def _global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: the L2 norm of all leaves together."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def make_train_step(
    config: BertConfig,
    optimizer: AdamW,
    *,
    temperature: float = 0.05,
    compute_dtype: torch.dtype = torch.float32,
    use_kernels: Optional[bool] = False,
    remat: bool = True,
    pooling: str = "mean",
):
    """(state, batch) → (state, metrics) step.

    batch = {ids_a, mask_a, ids_b, mask_b} ([B, T] arrays or tensors):
    positive sentence pairs. metrics = {"loss", "grad_norm"} (0-d
    tensors), the norm taken over all gradients before the update.
    Per-layer rematerialization is on by default: the backward recomputes
    each layer's activations instead of keeping them, so activation
    residency is O(1) in depth. ``optimizer`` is the spec the state's
    AdamW was built by; a state built by another raises, since a torch
    optimizer carries its own hyperparameters. The step runs on the
    device of the state's parameters. ``use_kernels`` must stay False:
    the kernels have no backward (bert_tpu's step takes
    ``use_pallas=False`` too).
    """
    if use_kernels is not False:
        raise ValueError("make_train_step: use_kernels must be False — the "
                         "kernels have no backward; training runs the "
                         "plain versions, as bert_tpu's does")

    def loss_fn(model: TrainableBertModel,
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        # pooling must match the checkpoint's readout (engine.pooling):
        # contrastive-tuning a CLS model through a mean-pooled loss trains
        # the wrong vector
        emb_a, emb_b = (
            bert_forward(model, batch[f"ids_{s}"], batch[f"mask_{s}"],
                         compute_dtype=compute_dtype, use_kernels=False,
                         remat=remat, pooling=pooling)
            for s in ("a", "b"))
        return info_nce_loss(emb_a, emb_b, temperature)

    def train_step(state: TrainState, batch: Dict[str, Any]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model, opt = state.params, state.opt_state
        if not optimizer.built(opt):
            raise ValueError("train state's optimizer was not built by "
                             f"{optimizer}")
        dev = model.embeddings["word"].device
        b = {k: _tensor(v).to(dev, torch.int64 if k.startswith("ids")
                              else torch.float32)
             for k, v in batch.items()}
        params = list(model.parameters())
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, b)
        loss.backward()
        for p in params:  # optax updates every leaf, a zero gradient too
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        gnorm = _global_norm(p.grad for p in params)
        opt.step()
        return (TrainState(params=model, opt_state=opt, step=state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm})

    return train_step


def adam_moments(state: TrainState):
    """The AdamW moments of ``state`` as host trees keyed as
    ``params.tree()`` (whole leaves: a tensor-parallel shard's are
    gathered, a collective), and optax's ``count``; None before the first
    step (no moments yet)."""
    model, opt = state.params, state.opt_state
    mu, nu, counts = {}, {}, set()
    for group, sub in model.tree().items():
        for key, p in sub.items():
            st = opt.state.get(p)
            if not st:
                return None
            for tree, name in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
                tree.setdefault(group, {})[key] = gather_leaf(
                    group, key, st[name], model.tp_group).cpu().numpy()
            counts.add(int(st["step"]))
    if len(counts) != 1:
        raise ValueError(f"AdamW step counts differ across parameters: "
                         f"{sorted(counts)}")
    return mu, nu, counts.pop()


def make_sharded_train_step(
    mesh,
    config: BertConfig,
    optimizer: AdamW,
    state: TrainState,
    *,
    temperature: float = 0.05,
    compute_dtype: torch.dtype = torch.float32,
    pooling: str = "mean",
):
    """A train step over the mesh, and ``state`` placed on it. Returns
    (placed_state, step).

    ``state`` is a whole (single-device) TrainState, the same on every
    rank; each rank keeps its ``model``-axis shard of the parameters and
    of the AdamW moments, on its device. Restored moments are cut like
    the parameters, never reset. ``step(state, batch)`` takes the whole
    batch on every rank: each rank runs its ``data``-axis rows, the
    embeddings are all-gathered over ``data`` (a gather whose backward
    keeps this rank's rows and sums nothing: every rank computes the same
    loss, so a summing backward would multiply the gradient by dp), the
    InfoNCE loss is taken over the whole batch, and every gradient is
    summed over ``data``. ``grad_norm`` is the global L2 norm: sharded
    leaves summed over ``model``, replicated ones counted once (their
    replicas take model rank 0's gradient, so that they never drift). The
    step runs the plain versions (bert_tpu's takes ``use_pallas=False``)
    with per-layer remat, as :func:`make_train_step` does.
    """
    if DATA_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"mesh axes {tuple(mesh.mesh_dim_names or ())} lack "
            f"'{DATA_AXIS}' — build the mesh with parallel.mesh.make_mesh "
            f"(axes '{DATA_AXIS}'/'{MODEL_AXIS}')")
    tp = axis_size(mesh, MODEL_AXIS)
    m = mesh.get_local_rank(MODEL_AXIS) if tp > 1 else 0
    dp_group = axis_group(mesh, DATA_AXIS)
    model = TrainableBertModel(
        params_to_torch(shard_params(params_to_numpy(state.params), tp, m),
                        device=rank_device(mesh)), config,
        tp_group=axis_group(mesh, MODEL_AXIS))
    opt = optimizer.init(model)
    moments = adam_moments(state)
    if moments is not None:
        mu, nu, count = moments
        place_adam_state(opt, model, shard_params(mu, tp, m),
                         shard_params(nu, tp, m), count)
    placed = TrainState(params=model, opt_state=opt, step=state.step,
                        mesh=mesh)
    # (parameter, whether it is a model-axis shard)
    leaves = [(p, split_dim(g, k) is not None and tp > 1)
              for g, sub in model.tree().items() for k, p in sub.items()]

    def train_step(state: TrainState, batch: Dict[str, Any]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model, opt = state.params, state.opt_state
        if not optimizer.built(opt):
            raise ValueError("train state's optimizer was not built by "
                             f"{optimizer}")
        dev = model.embeddings["word"].device
        rows = local_rows(mesh, np.shape(batch["ids_a"])[0])
        b = {k: _tensor(v)[rows].to(dev, torch.int64 if k.startswith("ids")
                                    else torch.float32)
             for k, v in batch.items()}
        opt.zero_grad(set_to_none=True)
        emb_a, emb_b = (gather_rows(bert_forward(
            model, b[f"ids_{s}"], b[f"mask_{s}"],
            compute_dtype=compute_dtype, use_kernels=False, remat=True,
            pooling=pooling), dp_group) for s in ("a", "b"))
        loss = info_nce_loss(emb_a, emb_b, temperature)
        loss.backward()
        for p, cut in leaves:  # optax updates every leaf, a zero grad too
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            all_reduce_(p.grad, dp_group)
            if not cut:
                # the model group's replicas of a replicated leaf take one
                # gradient, so that a kernel that sums in no fixed order
                # (the embedding backward's atomics) cannot drift them
                broadcast_(p.grad, model.tp_group)
        sq = [(torch.sum(torch.square(p.grad.float())), cut)
              for p, cut in leaves]
        sq_sharded = sum(s for s, cut in sq if cut)
        if isinstance(sq_sharded, torch.Tensor):
            all_reduce_(sq_sharded, model.tp_group)
        gnorm = torch.sqrt(sq_sharded + sum(s for s, cut in sq if not cut))
        opt.step()
        return (TrainState(params=model, opt_state=opt, step=state.step + 1,
                           mesh=mesh),
                {"loss": loss.detach(), "grad_norm": gnorm})

    return placed, train_step

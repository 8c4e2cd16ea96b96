"""Checkpointing: the native ``.npz`` weight cache and the train state.

Counterpart of ``bert_tpu/checkpoint.py``.

* :func:`save_params`, :func:`load_params`, :func:`load_params_and_vocab`
  write and read the weight cache in bert_tpu's file format, so a cache
  written by either package loads in the other: one ``np.savez`` archive
  holding the layer-stacked host params tree (QuantTensors kept packed as
  ``<group>/<key>.packed|.scales|.mins``), the config as JSON in
  ``__meta__`` (with ``__format_version__`` and, when known,
  ``__pooling__``) and the vocab in ``__vocab__``. Loading it skips
  parsing, stacking and repacking.
* :func:`save_train_state` / :func:`load_train_state` save and resume
  contrastive fine-tuning (bert_tpu_torch/train.py) in the port's own
  format: one ``torch.save`` archive, ``<dir>/train_state.pt``, of plain
  tensors and ints (params, the AdamW moments, AdamW's step count and the
  train step), read back with ``weights_only=True``. A tensor-parallel
  train state (train.make_sharded_train_step) is gathered whole and rank 0
  writes it; :func:`load_train_state` reads it into a whole state, which
  ``make_sharded_train_step`` cuts for any mesh, so a state saved at one
  (dp, tp) resumes at any other, or on one device. bert_tpu saves its
  train state with orbax, whose directories this module cannot read: the
  port does not depend on orbax or JAX. To carry a bert_tpu train state
  across, use :func:`bert_tpu_torch.params.train_state_from_jax`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .params import BertConfig
from .quant import QuantTensor

_FORMAT_VERSION = 1


def _flatten(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for group, sub in params.items():
        for key, val in sub.items():
            base = f"{group}/{key}"
            if hasattr(val, "packed"):  # a QuantTensor of either package
                flat[base + ".packed"] = np.asarray(val.packed)
                flat[base + ".scales"] = np.asarray(val.scales)
                if val.mins is not None:
                    flat[base + ".mins"] = np.asarray(val.mins)
            else:
                flat[base] = np.asarray(val)
    return flat


def save_params(path: str, params: Dict[str, Any], config: BertConfig,
                vocab_tokens=None, pooling=None) -> None:
    if not path.endswith(".npz"):
        # np.savez would append ".npz", and load_model dispatches on the
        # suffix, so the caller's path would then misroute to the ggml parser
        raise ValueError(f"weight-cache path must end in .npz, got {path!r}")
    meta = dict(config.__dict__)
    meta["__format_version__"] = _FORMAT_VERSION
    if pooling is not None:
        meta["__pooling__"] = pooling  # a model property: mean vs cls
    extra = {}
    if vocab_tokens is not None:
        extra["__vocab__"] = np.asarray(list(vocab_tokens), dtype=np.str_)
    np.savez(path, __meta__=json.dumps(meta), **extra, **_flatten(params))


def load_params(path: str) -> Tuple[BertConfig, Dict[str, Any]]:
    config, params, _, _ = load_params_and_vocab(path)
    return config, params


def load_params_and_vocab(path: str):
    """→ (config, params, vocab tokens or None, pooling or None)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        version = meta.pop("__format_version__", 0)
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported weight-cache version {version}")
        pooling = meta.pop("__pooling__", None)
        config = BertConfig(**meta)
        vocab_tokens = ([str(t) for t in z["__vocab__"]]
                        if "__vocab__" in z else None)
        params: Dict[str, Dict[str, Any]] = {}
        names = [n for n in z.files if n not in ("__meta__", "__vocab__")]
        quant_bases = {n.rsplit(".", 1)[0] for n in names
                       if n.endswith(".packed")}
        for name in names:
            base = name.rsplit(".", 1)[0] if "." in name.split("/")[-1] \
                else name
            group, key = base.split("/", 1)
            sub = params.setdefault(group, {})
            if key in sub:
                continue
            if base in quant_bases:
                sub[key] = QuantTensor(
                    packed=z[base + ".packed"], scales=z[base + ".scales"],
                    mins=z[base + ".mins"] if base + ".mins" in z else None)
            else:
                sub[key] = z[name]
    return config, params, vocab_tokens, pooling


# --- training state ---------------------------------------------------------

TRAIN_STATE_FILE = "train_state.pt"
_TRAIN_STATE_VERSION = 1


def save_train_state(ckpt_dir: str, state) -> None:
    """Write ``state`` (a :class:`bert_tpu_torch.train.TrainState`) to
    ``<ckpt_dir>/train_state.pt``, replacing it whole (written aside, then
    renamed). For a state on a mesh, every rank calls it: the leaves are
    gathered whole, rank 0 writes, and every rank returns once the file is
    in place."""
    from .params import params_to_numpy
    from .train import adam_moments

    params = params_to_numpy(state.params)
    moments = adam_moments(state)
    if moments is None:  # no step taken yet
        moments = ({g: {k: np.zeros_like(v) for k, v in sub.items()}
                    for g, sub in params.items()},) * 2 + (0,)
    mu, nu, count = moments
    mesh = state.mesh
    if mesh is None or torch.distributed.get_rank() == 0:
        flat = {name: {f"{g}/{k}": torch.from_numpy(v)
                       for g, sub in tree.items() for k, v in sub.items()}
                for name, tree in (("params", params), ("mu", mu),
                                   ("nu", nu))}
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, TRAIN_STATE_FILE)
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.save({"version": _TRAIN_STATE_VERSION,
                    "step": int(state.step), "count": count, **flat}, tmp)
        os.replace(tmp, path)
    if mesh is not None:
        torch.distributed.barrier()


def load_train_state(ckpt_dir: str, target):
    """Restore into ``target`` (an initialized TrainState over a model of
    the same config): its parameters take the saved values and its AdamW
    the saved moments and step count, placed as saved, never reset.
    Returns the TrainState at the saved step."""
    from .train import TrainState, place_adam_state

    path = os.path.join(ckpt_dir, TRAIN_STATE_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{ckpt_dir}: no {TRAIN_STATE_FILE}. The port reads only its "
            "own train-state format, not bert_tpu's orbax directories")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if saved.get("version") != _TRAIN_STATE_VERSION:
        raise ValueError(f"unsupported train-state version "
                         f"{saved.get('version')}")
    tree = target.params.tree()
    names = {f"{g}/{k}" for g, sub in tree.items() for k in sub}
    if set(saved["params"]) != names:
        raise ValueError(f"{path} holds {sorted(saved['params'])}, the "
                         f"model {sorted(names)}")

    def unflatten(flat):
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, t in flat.items():
            group, key = name.split("/", 1)
            out.setdefault(group, {})[key] = t
        return out

    with torch.no_grad():
        for group, sub in unflatten(saved["params"]).items():
            for key, t in sub.items():
                p = tree[group][key]
                if t.shape != p.shape:
                    raise ValueError(f"{group}/{key}: saved {tuple(t.shape)}"
                                     f", model {tuple(p.shape)}")
                p.copy_(t)
    place_adam_state(target.opt_state, target.params,
                     unflatten(saved["mu"]), unflatten(saved["nu"]),
                     saved["count"])
    return TrainState(params=target.params, opt_state=target.opt_state,
                      step=saved["step"])

"""The native ``.npz`` weight cache.

Counterpart of the weight-cache half of ``bert_tpu/checkpoint.py``
(:func:`save_params`, :func:`load_params`, :func:`load_params_and_vocab`),
in the same file format, so a cache written by either package loads in the
other: one ``np.savez`` archive holding the layer-stacked host params tree
(QuantTensors kept packed as ``<group>/<key>.packed|.scales|.mins``), the
config as JSON in ``__meta__`` (with ``__format_version__`` and, when
known, ``__pooling__``) and the vocab in ``__vocab__``. Loading it skips
parsing, stacking and repacking. Training state waits for the training
slice (ROADMAP.md).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np

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

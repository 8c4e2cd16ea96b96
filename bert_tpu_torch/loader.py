"""Model loading: ggml-bin files, HF checkpoint directories and ``.npz``
weight caches → host params tree.

Counterpart of ``bert_tpu/loader.py`` (``LoadedModel``,
``params_from_ggml``, ``load_ggml_model``, ``load_hf_model``,
``load_model``). Tensors are validated against the expected name inventory
(bert.cpp:503-553) and assembled into the layer-stacked tree of
:mod:`bert_tpu_torch.params`. Q4 tensors of ggml files are REPACKED
bit-exactly (no dequant/requant) into the group-local
:class:`~bert_tpu_torch.quant.QuantTensor` layout; embedding tables are
densified (gathers want dense rows; the values equal ggml's per-use
dequantization). HF directories are read from ``model.safetensors`` (by the
port's own reader, formats/safetensors.py) or ``pytorch_model.bin``.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .checkpoint import load_params_and_vocab
from .formats.ggml_bin import GgmlModelFile, read_ggml
from .formats.safetensors import read_safetensors
from .params import (
    BertConfig,
    expected_tensor_names,
    fuse_qkv_bias,
    fuse_qkv_weights,
    params_from_named_tensors,
    _LAYER_WEIGHTS,
    _MATMUL_KEYS,
    _QKV_SOURCES,
    _EMB_WEIGHTS,
)
from .quant import (
    GGML_FTYPE_Q4_0,
    GGML_FTYPE_Q4_1,
    concat_quant_n,
    stack_quant,
)
from .vocab import Vocab


@dataclass
class LoadedModel:
    config: BertConfig
    params: Dict[str, Any]  # host tree (numpy / QuantTensor of numpy)
    vocab: Vocab
    # "mean" / "cls" when the checkpoint declares it; None = unknown → the
    # engine defaults to mean, the reference's hardcoded behavior
    # (bert.cpp:906-913). ggml files declare nothing.
    pooling: Optional[str] = None
    # per-phase wall times of THIS load, seconds. Keys: parse, emb_dequant,
    # repack, quantize; the engine adds to_device. Travels on the loaded
    # model so timings can never be attributed to a different load. Read
    # via BertTorch.stats()["load_phases"].
    load_phases: Dict[str, float] = field(default_factory=dict)


def _qkv_row_order(config: BertConfig) -> np.ndarray:
    """Row permutation mapping stacked [q; k; v] (3D rows of the stored
    [out, in] tensors) to the head-interleaved fused order."""
    d, h, dh = config.n_embd, config.n_head, config.d_head
    idx = np.empty(3 * d, dtype=np.int64)
    for head in range(h):
        for kind in range(3):
            src = kind * d + head * dh
            dst = head * 3 * dh + kind * dh
            idx[dst:dst + dh] = np.arange(src, src + dh)
    return idx


def params_from_ggml(mf: GgmlModelFile,
                     phases: Optional[Dict[str, float]] = None
                     ) -> Tuple[BertConfig, Dict[str, Any]]:
    if phases is None:
        phases = {}
    config = BertConfig.from_hparams(mf.hparams)

    missing = [n for n in expected_tensor_names(config) if n not in mf.tensors]
    if missing:
        raise ValueError(f"model file missing tensors: {missing[:5]}...")

    # ggml stores ftype PER TENSOR: the stacked layout below assumes every
    # layer's instance of a weight shares one codec — reject mixed files
    for key, tmpl in {**_LAYER_WEIGHTS,
                      **{f"qkv_{k}": v + ".weight"
                         for k, v in _QKV_SOURCES.items()}}.items():
        ftypes = {mf.tensors[tmpl.format(i=i)].ftype
                  for i in range(config.n_layer)}
        if len(ftypes) > 1:
            raise ValueError(
                f"{key}: per-layer ftypes differ across layers "
                f"({sorted(ftypes)}) — mixed-codec files are not supported")

    t0 = time.perf_counter()
    emb = {key: mf.tensors[name].to_f32()
           for key, name in _EMB_WEIGHTS.items()}
    phases["emb_dequant"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    h = config.n_head
    layers: Dict[str, Any] = {}

    # fused QKV: stored tensors are [out, in] with q4 blocks along in, so
    # fusing is a pure ROW concat+permute of the stored layout — a COLUMN
    # permutation of the group-local layout, bit-exact for quantized files
    order = _qkv_row_order(config)
    qt_list, w_list, b_list = [], [], []
    for i in range(config.n_layer):
        recs = [mf.tensors[_QKV_SOURCES[k].format(i=i) + ".weight"]
                for k in ("q", "k", "v")]
        brecs = [mf.tensors[_QKV_SOURCES[k].format(i=i) + ".bias"]
                 for k in ("q", "k", "v")]
        b_list.append(fuse_qkv_bias(*[r.to_f32() for r in brecs], h))
        if recs[0].ftype in (GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1):
            qt_list.append(concat_quant_n([r.to_quant_tpu() for r in recs],
                                          col_order=order))
        else:
            w_list.append(fuse_qkv_weights(*[r.to_f32().T for r in recs], h))
    layers["qkv_w"] = stack_quant(qt_list) if qt_list else np.stack(w_list)
    layers["qkv_b"] = np.stack(b_list)

    for key, tmpl in _LAYER_WEIGHTS.items():
        recs = [mf.tensors[tmpl.format(i=i)] for i in range(config.n_layer)]
        if key in _MATMUL_KEYS and recs[0].ftype in (GGML_FTYPE_Q4_0,
                                                     GGML_FTYPE_Q4_1):
            # file stores [out, in] with q4 blocks along in (= ggml ne[0]);
            # the fused stream repack transposes to logical W[in, out]
            layers[key] = stack_quant([r.to_quant_tpu() for r in recs])
        elif key in _MATMUL_KEYS:
            layers[key] = np.stack([r.to_f32().T for r in recs])
        else:
            layers[key] = np.stack([r.to_f32() for r in recs])

    phases["repack"] = round(time.perf_counter() - t0, 3)
    return config, {"embeddings": emb, "layers": layers}


def load_ggml_model(path: str,
                    quantize_ftype: Optional[int] = None) -> LoadedModel:
    """``quantize_ftype`` quantizes a dense (f32/f16) file's matmul weights
    on load — one-step parity with running models/quantize.cpp first.
    Files already stored quantized keep their bit-exact repacked codes
    (requesting a different ftype for them is an error, not a requant)."""
    if quantize_ftype not in (None, GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1):
        raise ValueError(f"quantize-on-load supports q4_0/q4_1 only, "
                         f"got ftype {quantize_ftype}")
    phases: Dict[str, float] = {}
    t0 = time.perf_counter()
    mf = read_ggml(path)
    phases["parse"] = round(time.perf_counter() - t0, 3)
    stored_ftype = int(mf.hparams.ftype)
    if (quantize_ftype is not None
            and stored_ftype in (GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1)
            and stored_ftype != quantize_ftype):
        raise ValueError(
            f"{path} stores ftype {stored_ftype}; refusing a lossy "
            f"requantization to {quantize_ftype}")
    config, params = params_from_ggml(mf, phases)
    if (quantize_ftype is not None
            and config.ftype not in (GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1)):
        from .params import quantize_params

        t0 = time.perf_counter()
        params = quantize_params(params, quantize_ftype)
        config = BertConfig(**{**config.__dict__, "ftype": quantize_ftype})
        phases["quantize"] = round(time.perf_counter() - t0, 3)
    vocab = Vocab.from_tokens(mf.vocab_tokens)
    return LoadedModel(config=config, params=params, vocab=vocab,
                       load_phases=phases)


def _detect_pooling(model_dir: str) -> Optional[str]:
    """Pooling mode declared by a sentence-transformers checkpoint
    (``1_Pooling/config.json``: ``pooling_mode_cls_token`` → "cls",
    ``pooling_mode_mean_tokens`` → "mean"); None when nothing is declared."""
    try:
        with open(os.path.join(model_dir, "1_Pooling", "config.json"),
                  encoding="utf-8") as f:
            pc = json.load(f)
    except (OSError, ValueError):
        return None
    if pc.get("pooling_mode_cls_token"):
        return "cls"
    if pc.get("pooling_mode_mean_tokens"):
        return "mean"
    return None


def load_hf_model(model_dir: str,
                  quantize_ftype: Optional[int] = None) -> LoadedModel:
    """Load a HuggingFace BERT checkpoint directory directly (no ggml-bin
    intermediate). Skips ``embeddings.position_ids`` and ``pooler.dense.*``
    as the converter does (convert-to-ggml.py:86-87)."""
    if quantize_ftype not in (None, GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1):
        raise ValueError(f"quantize-on-load supports q4_0/q4_1 only, "
                         f"got ftype {quantize_ftype}")
    phases: Dict[str, float] = {}
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        hf_cfg = json.load(f)
    # the tanh-approximate GELU variants; plain "gelu" is exact erf
    approx_acts = ("gelu_new", "gelu_fast", "gelu_pytorch_tanh")
    config = BertConfig(
        n_vocab=hf_cfg["vocab_size"],
        n_max_tokens=hf_cfg["max_position_embeddings"],
        n_embd=hf_cfg["hidden_size"],
        n_intermediate=hf_cfg["intermediate_size"],
        n_head=hf_cfg["num_attention_heads"],
        n_layer=hf_cfg["num_hidden_layers"],
        ftype=quantize_ftype or 0,
        layer_norm_eps=float(hf_cfg.get("layer_norm_eps", 1e-12)),
        gelu_approx=hf_cfg.get("hidden_act", "gelu") in approx_acts,
    )
    t0 = time.perf_counter()
    named = _hf_state_dict(model_dir)
    named = {k: v for k, v in named.items()
             if k not in ("embeddings.position_ids", "pooler.dense.weight",
                          "pooler.dense.bias")}
    phases["parse"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    params = params_from_named_tensors(named, config,
                                       quantize_ftype=quantize_ftype)
    phases["repack" if quantize_ftype is None else "quantize"] = round(
        time.perf_counter() - t0, 3)
    vocab = Vocab.from_vocab_txt(os.path.join(model_dir, "vocab.txt"))
    if len(vocab) > config.n_vocab:
        # added tokens beyond config vocab_size would emit ids past the
        # embedding table: truncate as the converter does
        vocab = Vocab.from_tokens(vocab.tokens[: config.n_vocab])
    return LoadedModel(config=config, params=params, vocab=vocab,
                       pooling=_detect_pooling(model_dir),
                       load_phases=phases)


def _hf_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    """HF weights from ``model.safetensors`` (preferred, as bert_tpu
    prefers it) or ``pytorch_model.bin``, with the "bert." prefix some
    checkpoints carry stripped and each tensor squeezed as the converter
    does (convert-to-ggml.py:85)."""
    st_path = os.path.join(model_dir, "model.safetensors")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        raw = read_safetensors(st_path)
    elif os.path.exists(bin_path):
        import torch

        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        raw = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
               for k, v in sd.items()}
    else:
        raise FileNotFoundError(f"{model_dir}: no model.safetensors or "
                                "pytorch_model.bin")
    return {(k[5:] if k.startswith("bert.") else k): np.asarray(v).squeeze()
            for k, v in raw.items()}


def load_model(path: str,
               quantize_ftype: Optional[int] = None) -> LoadedModel:
    """Dispatch: native .npz weight cache, ggml-bin file, or HF directory."""
    if os.path.isdir(path):
        return load_hf_model(path, quantize_ftype=quantize_ftype)
    if path.endswith(".npz"):
        t0 = time.perf_counter()
        config, params, vocab_tokens, pooling = load_params_and_vocab(path)
        if vocab_tokens is None:
            raise ValueError(f"{path}: weight cache has no vocab; "
                             "save with vocab_tokens")
        return LoadedModel(config=config, params=params,
                           vocab=Vocab.from_tokens(vocab_tokens),
                           pooling=pooling, load_phases={
                               "parse": round(time.perf_counter() - t0, 3)})
    return load_ggml_model(path, quantize_ftype=quantize_ftype)

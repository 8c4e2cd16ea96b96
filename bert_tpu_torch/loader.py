"""Model loading: ggml-bin files → host params tree.

Counterpart of the ggml path of ``bert_tpu/loader.py`` (``LoadedModel``,
``params_from_ggml``, ``load_ggml_model``). Tensors are validated against
the expected name inventory (bert.cpp:503-553) and assembled into the
layer-stacked tree of :mod:`bert_tpu_torch.params`. Q4 tensors are REPACKED
bit-exactly (no dequant/requant) into the group-local
:class:`~bert_tpu_torch.quant.QuantTensor` layout; embedding tables are
densified (gathers want dense rows; the values equal ggml's per-use
dequantization).

HF checkpoint directories and ``.npz`` weight caches are not ported yet
(ROADMAP.md, "Still to port": the HF and .npz loaders).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .formats.ggml_bin import GgmlModelFile, read_ggml
from .params import (
    BertConfig,
    expected_tensor_names,
    fuse_qkv_bias,
    fuse_qkv_weights,
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


def load_model(path: str,
               quantize_ftype: Optional[int] = None) -> LoadedModel:
    """Dispatch on the path: only ggml-bin files are ported so far."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: HF checkpoint directories are not ported to "
            "bert_tpu_torch yet (ROADMAP.md, 'Still to port': the HF and "
            ".npz loaders); convert to ggml-bin or use bert_tpu")
    if path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: .npz weight caches are not ported to bert_tpu_torch "
            "yet (ROADMAP.md, 'Still to port': the HF and .npz loaders)")
    return load_ggml_model(path, quantize_ftype=quantize_ftype)

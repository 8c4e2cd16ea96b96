"""Model conversion and quantization (counterpart of ``bert_tpu/convert.py``).

  * HF checkpoint directory → ggml-bin f32/f16, as the reference's
    models/convert-to-ggml.py writes it: the same header, vocab framing,
    skip list (``embeddings.position_ids``, ``pooler.dense.*``), "2-D
    ``.weight`` tensors take the file dtype" rule and reversed-dims tensor
    records;
  * ggml-bin f32/f16 → Q4_0/Q4_1 (models/quantize.cpp), with its per-tensor
    log lines and 16-bin nibble code histograms, per tensor and global.

The output files are byte for byte bert_tpu's. Entry points, argument for
argument those of tools/convert_hf.py and tools/quantize.py::

    python -m bert_tpu_torch.convert hf <model-dir> [0|1]    # 0 f32, 1 f16
    python -m bert_tpu_torch.convert quantize <in> <out> <2|3|q4_0|q4_1>

(``hf`` writes ``<model-dir>/ggml-model-f16.bin``, or ``-f32``.)

tools/convert_hf.py downloads a missing directory from the HF hub; this
entry point does not (it would need the network and ``transformers``),
and says so. ``BertTorch.from_file`` also loads HF directories directly:
the ggml-bin file is for interchange with the reference, not a required
step.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional

import numpy as np

from .formats.ggml_bin import GgmlHParams, read_ggml, write_ggml
from .quant import (
    FTYPE_BY_NAME,
    FTYPE_NAMES,
    GGML_FTYPE_F16,
    GGML_FTYPE_F32,
    GGML_FTYPE_Q4_0,
    GGML_FTYPE_Q4_1,
    ggml_nbytes,
    nibble_histogram,
)

CONVERT_SKIP = ("embeddings.position_ids", "pooler.dense.weight",
                "pooler.dense.bias")  # convert-to-ggml.py:86-87


def convert_hf_to_ggml(model_dir: str, out_path: Optional[str] = None,
                       ftype: int = GGML_FTYPE_F16) -> str:
    """HF BERT checkpoint directory → ggml-bin file. Returns output path."""
    from .loader import _detect_pooling, _hf_state_dict

    assert ftype in (GGML_FTYPE_F32, GGML_FTYPE_F16)
    if _detect_pooling(model_dir) == "cls":
        # the ggml format has no pooling field, so the checkpoint's
        # declared CLS pooling cannot travel with the file
        print(f"warning: {model_dir} declares CLS pooling "
              "(1_Pooling/config.json); the ggml-bin format cannot record "
              "it — load the converted file with pooling='cls' "
              "(--pooling cls)", file=sys.stderr)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(model_dir, "vocab.txt"), encoding="utf-8") as f:
        vocab = [line.rstrip("\n") for line in f][: cfg["vocab_size"]]

    hp = GgmlHParams(
        n_vocab=cfg["vocab_size"],
        n_max_tokens=cfg["max_position_embeddings"],
        n_embd=cfg["hidden_size"],
        n_intermediate=cfg["intermediate_size"],
        n_head=cfg["num_attention_heads"],
        n_layer=cfg["num_hidden_layers"],
        ftype=ftype,
    )
    tensors = {name: arr for name, arr in _hf_state_dict(model_dir).items()
               if name not in CONVERT_SKIP}
    if out_path is None:
        suffix = {GGML_FTYPE_F32: "f32", GGML_FTYPE_F16: "f16"}[ftype]
        out_path = os.path.join(model_dir, f"ggml-model-{suffix}.bin")
    write_ggml(out_path, hp, vocab, tensors, tensor_order=list(tensors))
    return out_path


def quantize_ggml(in_path: str, out_path: str, ftype: int,
                  log=print) -> Dict[str, int]:
    """Re-encode an f32/f16 ggml-bin to Q4_0/Q4_1.

    Same eligibility rule as the reference (2-D ``*.weight``,
    quantize.cpp:154-167); logs per-tensor and global nibble histograms.
    Returns {"total_in": bytes, "total_out": bytes}.
    """
    assert ftype in (GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1)
    mf = read_ggml(in_path)
    if mf.hparams.ftype not in (GGML_FTYPE_F32, GGML_FTYPE_F16):
        raise ValueError(
            f"source must be f32/f16, got {FTYPE_NAMES[mf.hparams.ftype]}"
        )

    hp = GgmlHParams(**{**mf.hparams.__dict__})
    hp.ftype = ftype

    tensors: Dict[str, np.ndarray] = {}
    total_in = 0
    for name, rec in mf.tensors.items():
        tensors[name] = rec.to_f32()
        total_in += tensors[name].size * (2 if rec.ftype == GGML_FTYPE_F16
                                          else 4)

    # the writer quantizes each eligible tensor once; the histograms come
    # from the records read back, cheaper than quantizing twice
    write_ggml(out_path, hp, mf.vocab_tokens, tensors,
               tensor_order=list(mf.tensors))

    global_hist = np.zeros(16, dtype=np.int64)
    total_out = 0
    for name, rec in read_ggml(out_path).tensors.items():
        nbytes_out = ggml_nbytes(rec.shape, rec.ftype)
        total_out += nbytes_out
        if rec.ftype == ftype:
            hist = nibble_histogram(rec.codes)
            global_hist += hist
            log(f"{name:>48s} - {list(rec.shape)} → {FTYPE_NAMES[ftype]} "
                f"{nbytes_out / 1e6:7.2f} MB | hist "
                + " ".join(f"{h / max(rec.codes.size, 1):.3f}"
                           for h in hist))
        else:
            log(f"{name:>48s} - {list(rec.shape)} kept f32")
    tot = max(int(global_hist.sum()), 1)
    log("global code histogram: "
        + " ".join(f"{h / tot:.3f}" for h in global_hist))
    log(f"size: {total_in / 1e6:.2f} MB → {total_out / 1e6:.2f} MB")
    return {"total_in": total_in, "total_out": total_out}


def _main_hf(args) -> None:
    if not args:
        sys.exit(__doc__)
    model_dir = args[0]
    if not os.path.isdir(model_dir):
        sys.exit(f"{model_dir}: no such directory (this entry point does "
                 "not download from the HF hub; fetch the checkpoint first)")
    ftype = int(args[1]) if len(args) > 1 else 1
    if ftype not in (0, 1):
        sys.exit(f"invalid ftype {ftype} (0=f32, 1=f16)")
    out = convert_hf_to_ggml(model_dir, ftype=ftype)
    print(f"Done. Output file: {out}")


def _main_quantize(args) -> None:
    if len(args) != 3:
        sys.exit(__doc__)
    in_path, out_path, mode = args
    ftype = FTYPE_BY_NAME.get(mode, None)
    if ftype is None:
        try:
            ftype = int(mode)
        except ValueError:
            sys.exit(f"invalid type {mode!r}")
    if ftype not in (GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1):
        sys.exit("type must be 2 (q4_0) or 3 (q4_1)")
    quantize_ggml(in_path, out_path, ftype)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    commands = {"hf": _main_hf, "quantize": _main_quantize}
    if not argv or argv[0] not in commands:
        sys.exit(__doc__)
    commands[argv[0]](argv[1:])


if __name__ == "__main__":
    main()

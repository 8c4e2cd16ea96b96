"""ModernBERT as a Hugging Face checkpoint directory holds it
(``ModernBertModel``'s tensor names, ``config.json`` with ``model_type``
"modernbert", a WordPiece ``vocab.txt`` and sentence-transformers'
``1_Pooling/config.json`` declaring CLS pooling), dense f32 weights drawn
from the seed, which the program quantizes on load
(``engine.quantize_ftype``), and the plain reference of
``gpubench/reference/modernbert.py``, which quantizes the same matrices
the same way itself."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import torch

from gpubench.reference.modernbert import Reference  # noqa: F401

# config.json: the configuration's keys that transformers' ModernBertConfig
# reads, as published
HF_KEYS = ("architectures", "model_type", "hidden_size", "intermediate_size",
           "num_attention_heads", "num_hidden_layers", "vocab_size",
           "max_position_embeddings", "norm_eps", "norm_bias",
           "attention_bias", "mlp_bias", "hidden_activation",
           "global_attn_every_n_layers", "local_attention",
           "global_rope_theta", "local_rope_theta", "pad_token_id",
           "bos_token_id", "eos_token_id", "cls_token_id", "sep_token_id")

Shapes = List[Tuple[str, Tuple[int, ...], str]]


def tensor_list(cfg: dict) -> Shapes:
    """(name, shape, kind) in file order; kind is the draw's: ``table``,
    ``matrix`` or ``ln_weight``."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    out: Shapes = [("embeddings.tok_embeddings.weight",
                    (cfg["vocab_size"], d), "table"),
                   ("embeddings.norm.weight", (d,), "ln_weight")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}"
        if i > 0:
            out.append((f"{p}.attn_norm.weight", (d,), "ln_weight"))
        out += [(f"{p}.attn.Wqkv.weight", (3 * d, d), "matrix"),
                (f"{p}.attn.Wo.weight", (d, d), "matrix"),
                (f"{p}.mlp_norm.weight", (d,), "ln_weight"),
                (f"{p}.mlp.Wi.weight", (2 * f, d), "matrix"),
                (f"{p}.mlp.Wo.weight", (d, f), "matrix")]
    out.append(("final_norm.weight", (d,), "ln_weight"))
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def draw(cfg: dict, seed: int, device: torch.device
         ) -> Dict[str, torch.Tensor]:
    """name → f32 tensor on ``device``: one normal draw of every weight on
    one generator, scaled by the configuration's standard deviations
    (``weights``), norm weights 1 + std · z."""
    init = cfg["weights"]
    tensors = tensor_list(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    z = torch.randn(sum(_numel(s) for _, s, _ in tensors), generator=gen,
                    device=device)
    out, o = {}, 0
    for name, shape, kind in tensors:
        n = _numel(shape)
        t = z[o:o + n].reshape(shape)
        o += n
        if kind == "ln_weight":
            out[name] = 1.0 + init["ln_weight_std"] * t
        else:
            out[name] = init[f"{kind}_std"] * t
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> int:
    """The tensors as one safetensors file (an 8-byte header length, the
    JSON header, then each tensor's f32 bytes in turn); its size."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * 4
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.to(torch.float32).contiguous().cpu().numpy().tobytes())
        return f.tell()


def write(directory: str, cfg: dict, vocab: List[str],
          weights: Dict[str, torch.Tensor]) -> Tuple[str, int]:
    """The checkpoint directory under ``directory``; its path and bytes."""
    path = os.path.join(directory, "model")
    os.makedirs(os.path.join(path, "1_Pooling"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({k: cfg[k] for k in HF_KEYS if k in cfg}, f, indent=1)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(path, "1_Pooling", "config.json"), "w") as f:
        json.dump({"word_embedding_dimension": cfg["hidden_size"],
                   "pooling_mode_cls_token": cfg["pooling"] == "cls",
                   "pooling_mode_mean_tokens": cfg["pooling"] == "mean"}, f)
    n = write_safetensors(os.path.join(path, "model.safetensors"), weights)
    return path, n + sum(os.path.getsize(os.path.join(path, p)) for p in
                         ("config.json", "vocab.txt"))

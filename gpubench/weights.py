"""Weights of a configuration, drawn from the seed on the device, and the
ggml file the program loads them from.

Every 2-D ``*.weight`` tensor is Q4_0 as a ggml Q4_0 file holds it:
blocks of 32 weights along the input dimension, each 16 bytes of random
nibbles and a scale. Scales are drawn as float16 values (stored as the
format's f32) uniform in [0.5, 1.5] times ``std / 4.64`` (4.64 is the
standard deviation of a uniform code minus 8), so the tensor's weights
have about that standard deviation. Biases and LayerNorm parameters are
f32. The whole draw is a few large calls on one ``torch.Generator`` on
the device, so the same seed gives the same weights on the same device.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import torch

GGML_MAGIC = 0x67676D6C
F32, Q4_0 = 0, 2
CODE_STD = 4.64

Shapes = List[Tuple[str, Tuple[int, ...], str]]


def tensor_list(cfg: dict) -> Shapes:
    """(name, numpy shape, kind) in file order; kind is the draw's:
    ``table``/``matrix`` (Q4_0), ``ln_weight``, ``ln_bias``, ``bias``."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    out: Shapes = [
        ("embeddings.word_embeddings.weight", (cfg["vocab_size"], d),
         "table"),
        ("embeddings.position_embeddings.weight",
         (cfg["max_position_embeddings"], d), "table"),
        ("embeddings.token_type_embeddings.weight",
         (cfg["type_vocab_size"], d), "table"),
        ("embeddings.LayerNorm.weight", (d,), "ln_weight"),
        ("embeddings.LayerNorm.bias", (d,), "ln_bias"),
    ]
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}"
        for name, shape in (
                ("attention.self.query", (d, d)),
                ("attention.self.key", (d, d)),
                ("attention.self.value", (d, d)),
                ("attention.output.dense", (d, d))):
            out += [(f"{p}.{name}.weight", shape, "matrix"),
                    (f"{p}.{name}.bias", (d,), "bias")]
        out += [(f"{p}.attention.output.LayerNorm.weight", (d,), "ln_weight"),
                (f"{p}.attention.output.LayerNorm.bias", (d,), "ln_bias"),
                (f"{p}.intermediate.dense.weight", (f, d), "matrix"),
                (f"{p}.intermediate.dense.bias", (f,), "bias"),
                (f"{p}.output.dense.weight", (d, f), "matrix"),
                (f"{p}.output.dense.bias", (d,), "bias"),
                (f"{p}.output.LayerNorm.weight", (d,), "ln_weight"),
                (f"{p}.output.LayerNorm.bias", (d,), "ln_bias")]
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def draw(cfg: dict, seed: int, device: torch.device) -> Dict[str, object]:
    """name → (nibbles [blocks, 16] uint8, scales [blocks] f32, shape) for
    a Q4_0 tensor, or an f32 tensor."""
    init = cfg["weights"]
    tensors = tensor_list(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    q4 = [(n, s, k) for n, s, k in tensors if k in ("table", "matrix")]
    dense = [(n, s, k) for n, s, k in tensors if k not in ("table",
                                                           "matrix")]
    blocks = sum(_numel(s) // 32 for _, s, _ in q4)
    nib = torch.randint(0, 256, (blocks, 16), generator=gen, device=device,
                        dtype=torch.uint8)
    u = torch.rand(blocks, generator=gen, device=device)
    normal = torch.randn(sum(_numel(s) for _, s, _ in dense),
                         generator=gen, device=device)
    out: Dict[str, object] = {}
    b0 = 0
    for name, shape, kind in q4:
        nb = _numel(shape) // 32
        std = init["table_std" if kind == "table" else "matrix_std"]
        scale = ((0.5 + u[b0:b0 + nb]) * (std / CODE_STD)).to(
            torch.float16).to(torch.float32)
        out[name] = (nib[b0:b0 + nb], scale, shape)
        b0 += nb
    o = 0
    for name, shape, kind in dense:
        n = _numel(shape)
        z = normal[o:o + n].reshape(shape)
        o += n
        if kind == "ln_weight":
            out[name] = 1.0 + init["ln_weight_std"] * z
        elif kind == "ln_bias":
            out[name] = init["ln_bias_std"] * z
        else:
            out[name] = init["bias_std"] * z
    return out


def write_ggml(path: str, cfg: dict, vocab: List[str],
               weights: Dict[str, object]) -> int:
    """Write the draw as a ggml-bin Q4_0 file (bert.cpp's format: magic,
    seven i32 hyperparameters, the vocabulary, then each tensor's header
    and data); returns the bytes written."""
    hp = (cfg["vocab_size"], cfg["max_position_embeddings"],
          cfg["hidden_size"], cfg["intermediate_size"],
          cfg["num_attention_heads"], cfg["num_hidden_layers"], Q4_0)
    with open(path, "wb") as f:
        f.write(struct.pack("<I7i", GGML_MAGIC, *hp))
        for tok in vocab:
            raw = tok.encode("utf-8")
            f.write(struct.pack("<I", len(raw)) + raw)
        for name, shape, _ in tensor_list(cfg):
            value = weights[name]
            ne = tuple(reversed(shape))
            raw_name = name.encode("utf-8")
            if isinstance(value, tuple):
                nib, scale, _ = value
                rec = torch.cat([scale.contiguous().view(torch.uint8).view(
                    -1, 4), nib], dim=1)
                ftype, data = Q4_0, rec.cpu().numpy().tobytes()
            else:
                ftype = F32
                data = value.to(torch.float32).cpu().numpy().tobytes()
            f.write(struct.pack(f"<3i{len(ne)}i", len(ne), len(raw_name),
                                ftype, *ne))
            f.write(raw_name)
            f.write(data)
        return f.tell()

"""DeepSeek-V2 as an embedding backbone, as a Hugging Face checkpoint
directory holds it for the program: ``config.json`` with ``model_type``
"deepseek_v2" and the configuration's published keys, a WordPiece
``vocab.txt``, sentence-transformers' ``1_Pooling/config.json`` declaring
last-token pooling, and ``model.safetensors`` under
``DeepseekV2ForCausalLM``'s names (``model.`` prefix, no ``lm_head``)
whose matrices are Q4_0 blocks as the program's ggml files hold them (U8
[N, K/32, 20]: an f32 scale, then 16 bytes of nibbles) and whose norms and
routers are dense f32.

The weights are drawn from the seed on the device in a few large calls on
one ``torch.Generator``, as ``weights.py`` draws BERT's, with one
difference: every matrix's Q4_0 codes are uniform in 1..15, not 0..15, so
that the weights have mean 0, as a Q4_0 quantizer's codes of symmetric
weights have (the scale amax / 7 maps them to 1..15). Codes of mean -0.5
give every matrix a rank-one mean part larger than its random part, which
RMSNorm, unlike BERT's LayerNorm, does not take out: every text then
embeds to nearly the same vector. The scales are float16 values uniform
in [0.5, 1.5] times ``std / 4.32`` (4.32 the standard deviation of a code
minus 8), so the weights have about that standard deviation (``table_std`` for
the embedding table, ``attention_std`` for the attention's four
projections, ``matrix_std`` for the MLPs and experts); norm weights 1 +
``ln_weight_std`` · z and routers ``router_std`` · z in f32. A dense f32
draw of the whole model would be 63 GB; the codes are 9.6 GB.

The plain reference is ``gpubench/reference/deepseek_v2.py``; it
dequantizes one layer's codes at a time."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import torch

from gpubench.reference.deepseek_v2 import Reference  # noqa: F401

CODE_STD = (56 / 3) ** 0.5  # of a code uniform in 1..15, minus 8
RECORD = 20  # bytes of a Q4_0 block: f32 scale, 16 bytes of nibbles

# config.json: the configuration's keys that transformers' DeepseekV2Config
# and the published modeling_deepseek.py read, as published
HF_KEYS = ("architectures", "model_type", "attention_bias",
           "first_k_dense_replace", "hidden_act", "hidden_size",
           "intermediate_size", "kv_lora_rank", "max_position_embeddings",
           "moe_intermediate_size", "moe_layer_freq", "n_group",
           "n_routed_experts", "n_shared_experts", "norm_topk_prob",
           "num_attention_heads", "num_experts_per_tok", "num_hidden_layers",
           "num_key_value_heads", "q_lora_rank", "qk_nope_head_dim",
           "qk_rope_head_dim", "rms_norm_eps", "rope_scaling", "rope_theta",
           "routed_scaling_factor", "scoring_func", "seq_aux",
           "tie_word_embeddings", "topk_group", "topk_method", "v_head_dim",
           "vocab_size")

Shapes = List[Tuple[str, Tuple[int, ...], str]]


def tensor_list(cfg: dict) -> Shapes:
    """(name, shape, kind) in file order; kind is the draw's: ``matrix``
    (Q4_0, [N, K]), ``norm`` or ``router`` (dense f32)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    qh = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    out: Shapes = [("embed_tokens.weight", (cfg["vocab_size"], d),
                    "matrix")]

    def mlp(p, f):
        return [(p + "gate_proj.weight", (f, d), "matrix"),
                (p + "up_proj.weight", (f, d), "matrix"),
                (p + "down_proj.weight", (d, f), "matrix")]

    for i in range(cfg["num_hidden_layers"]):
        p, a = f"layers.{i}.", f"layers.{i}.self_attn."
        out += [(p + "input_layernorm.weight", (d,), "norm"),
                (a + "q_proj.weight", (h * qh, d), "matrix"),
                (a + "kv_a_proj_with_mqa.weight",
                 (r + cfg["qk_rope_head_dim"], d), "matrix"),
                (a + "kv_a_layernorm.weight", (r,), "norm"),
                (a + "kv_b_proj.weight",
                 (h * (cfg["qk_nope_head_dim"] + dv), r), "matrix"),
                (a + "o_proj.weight", (d, h * dv), "matrix"),
                (p + "post_attention_layernorm.weight", (d,), "norm")]
        if i < cfg["first_k_dense_replace"]:
            out += mlp(p + "mlp.", cfg["intermediate_size"])
            continue
        f = cfg["moe_intermediate_size"]
        out.append((p + "mlp.gate.weight", (cfg["n_routed_experts"], d),
                    "router"))
        for e in range(cfg["n_routed_experts"]):
            out += mlp(f"{p}mlp.experts.{e}.", f)
        if cfg.get("n_shared_experts"):
            out += mlp(p + "mlp.shared_experts.",
                       f * cfg["n_shared_experts"])
    out.append(("norm.weight", (d,), "norm"))
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def draw(cfg: dict, seed: int, device: torch.device) -> Dict[str, object]:
    """name → (nibbles [blocks, 16] uint8, scales [blocks] f32, (N, K)) for
    a matrix, or an f32 tensor."""
    init = cfg["weights"]
    tensors = tensor_list(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    q4 = [(n, s) for n, s, k in tensors if k == "matrix"]
    dense = [(n, s, k) for n, s, k in tensors if k != "matrix"]
    blocks = sum(_numel(s) // 32 for _, s in q4)
    codes = torch.randint(1, 16, (blocks, 32), generator=gen, device=device,
                          dtype=torch.uint8)
    nib = codes[:, 0::2] | (codes[:, 1::2] << 4)
    del codes
    u = torch.rand(blocks, generator=gen, device=device)
    normal = torch.randn(sum(_numel(s) for _, s, _ in dense), generator=gen,
                         device=device)
    out: Dict[str, object] = {}
    b0 = 0
    for name, shape in q4:
        nb = _numel(shape) // 32
        std = init["table_std" if name == "embed_tokens.weight"
                   else "attention_std" if ".self_attn." in name
                   else "matrix_std"]
        scale = ((0.5 + u[b0:b0 + nb]) * (std / CODE_STD)).to(
            torch.float16).to(torch.float32)
        out[name] = (nib[b0:b0 + nb], scale, shape)
        b0 += nb
    del u
    o = 0
    for name, shape, kind in dense:
        n = _numel(shape)
        z = normal[o:o + n].reshape(shape)
        o += n
        out[name] = (1.0 + init["ln_weight_std"] * z if kind == "norm"
                     else init["router_std"] * z)
    return out


def _records(value) -> torch.Tensor:
    nib, scale, (n, k) = value
    return torch.cat([scale.contiguous().view(torch.uint8).view(-1, 4), nib],
                     dim=1).reshape(n, k // 32, RECORD)


def write_safetensors(path: str, cfg: dict,
                      weights: Dict[str, object]) -> int:
    """The draw as one safetensors file, each tensor written as it is
    moved to the host; its size."""
    header, offset, order = {}, 0, []
    for name, shape, kind in tensor_list(cfg):
        if kind == "matrix":
            dtype, sh = "U8", [shape[0], shape[1] // 32, RECORD]
            n = _numel(sh)
        else:
            dtype, sh = "F32", list(shape)
            n = 4 * _numel(sh)
        header["model." + name] = {"dtype": dtype, "shape": sh,
                                   "data_offsets": [offset, offset + n]}
        offset += n
        order.append((name, kind))
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name, kind in order:
            v = weights[name]
            t = _records(v) if kind == "matrix" else v.to(torch.float32)
            f.write(t.contiguous().cpu().numpy().tobytes())
        return f.tell()


def write(directory: str, cfg: dict, vocab: List[str],
          weights: Dict[str, object]) -> Tuple[str, int]:
    """The checkpoint directory under ``directory``; its path and bytes."""
    path = os.path.join(directory, "model")
    os.makedirs(os.path.join(path, "1_Pooling"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({k: cfg[k] for k in HF_KEYS if k in cfg}, f, indent=1)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(path, "1_Pooling", "config.json"), "w") as f:
        json.dump({"word_embedding_dimension": cfg["hidden_size"],
                   "pooling_mode_lasttoken": cfg["pooling"] == "last"}, f)
    n = write_safetensors(os.path.join(path, "model.safetensors"), cfg,
                          weights)
    return path, n + sum(os.path.getsize(os.path.join(path, p)) for p in
                         ("config.json", "vocab.txt"))

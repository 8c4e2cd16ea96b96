"""DeepSeek-V2 (deepseek-ai/DeepSeek-V2-Lite's architecture) as an embedding
backbone on the port's path: the decoder's prefill alone, up to its final
norm, pooled at each row's last real token (sentence-transformers'
``pooling_mode_lasttoken``, as LLM-backbone embedders declare it). No KV
cache, decode step or sampler: an embedding needs none.

The forward, from the published ``modeling_deepseek.py`` (transformers'
``modeling_deepseek_v2.py`` is its copy):

    x = E[ids]                                (no position table, no norm)
    for each layer l:
        a = RMS_attn_l(x)
        q = a · Wq                            per head: 128 nope | 64 rope
        [c | kr] = a · Wkv_a                  latent 512, one rope key 64
        [k_nope_h | v_h] = RMS_kv_l(c) · Wkv_b
        q_rope, kr = RoPE(q_rope), RoPE(kr)   YaRN-scaled, kr shared by heads
        x = x + Wo · softmax(s · q·[k_nope|kr]ᵀ + causal) · v
        b = RMS_ffn_l(x)
        l < first_k_dense:  x = x + Wd(silu(b·Wg) ⊙ b·Wu)
        else: p = softmax(b · Wrᵀ) in f32; the top k of p (greedy, not
              renormalised, times the routed scale) weigh their experts'
              SwiGLU outputs, and the shared experts' SwiGLU is added
    h = RMS_final(x)

with s = qk_head_dim^-½ · m², m = 0.1 · mscale_all_dim · ln(factor) + 1
(the published code's softmax scale under YaRN; transformers 4.57's
native class leaves m² out, so the two agree only without
``rope_scaling``). No projection or norm has a bias.

The checkpoint's rope rows (the last 64 of each head of ``q_proj``, and of
``kv_a_proj_with_mqa``) rotate interleaved pairs (2i, 2i+1); the loader
moves them to the de-interleaved order (even lanes, then odd), the
published code's own permutation, so that RoPE is rotate-half over them.
q·k is unchanged, and the move is of whole output rows, so it is bit-exact
on Q4_0 codes. Each MoE layer's experts are stacked into one Q4 tensor a
product, their gate and up rows interleaved in runs of 8
(``ops.moe.swiglu_order``); the dense layer's and the shared experts' gate
and up are one product whose first half is the gate.

The checkpoint: a directory with ``config.json`` (``model_type``
"deepseek_v2", keys as published), ``vocab.txt`` (the port's WordPiece
front end: the published byte-level BPE is not read),
``1_Pooling/config.json`` and ``model.safetensors`` whose matrices are
Q4_0: uint8 tensors [N, K/32, 20] of ggml Q4_0 blocks as the port's ggml
files hold them (an f32 scale, then 16 bytes of nibbles), the norms and the
router dense f32. ``lm_head`` is ignored.

The params tree: ``{"embeddings": {word}, "layers": {...}}`` with every
per-layer tensor stacked over its layers: the attention's and norms'
over all L, layer 0's MLP over the dense layers, the router, experts and
shared experts over the MoE layers (``DeepseekV2Config.n_moe_layers``),
and ``final_norm`` [D].
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .model import _plain, _Weights, dense, layer_slice
from .ops.fused_attention import rope_tables
from .ops.layer_norm import (add_rms_norm, add_rms_norm_plain, rms_norm,
                             rms_norm_plain)
from .ops.mla_attention import (causal_attention, causal_attention_plain,
                                rope_mla, rope_mla_plain, yarn_inv_freq)
from .ops.moe import (expert_matmul, expert_matmul_plain, moe_combine,
                      moe_combine_plain, moe_route, moe_route_plain,
                      swiglu_order)
from .params import DeepseekV2Config, yarn_mscale
from .quant import (GGML_FTYPE_Q4_0, QK, QuantTensor, dequantize_tpu,
                    repack_ggml_stream_tpu)

IGNORED_PREFIXES = ("lm_head.",)
Q4_RECORD = 20  # bytes of a ggml Q4_0 block as the port's files hold it


def config_from_hf(hf: dict) -> DeepseekV2Config:
    """The config of a ``config.json`` with ``model_type`` "deepseek_v2";
    refuses what the port does not run."""
    def refuse(what):
        raise ValueError(f"deepseek_v2: {what} is not supported")

    if hf.get("q_lora_rank") is not None:
        refuse(f"q_lora_rank {hf['q_lora_rank']} (q through a low-rank "
               "pair)")
    if hf.get("topk_method", "greedy") != "greedy":
        refuse(f"topk_method {hf['topk_method']!r} (only 'greedy')")
    if hf.get("scoring_func", "softmax") != "softmax":
        refuse(f"scoring_func {hf['scoring_func']!r} (only 'softmax')")
    if hf.get("norm_topk_prob"):
        refuse("norm_topk_prob true (the weights are not renormalised)")
    if hf.get("hidden_act", "silu") != "silu":
        refuse(f"hidden_act {hf['hidden_act']!r} (only 'silu')")
    if hf.get("attention_bias") or hf.get("mlp_bias"):
        refuse("a bias (the published model has none)")
    if hf.get("moe_layer_freq", 1) != 1:
        refuse(f"moe_layer_freq {hf['moe_layer_freq']}")
    rs = hf.get("rope_scaling")
    if rs is not None and rs.get("type", rs.get("rope_type")) != "yarn":
        refuse(f"rope_scaling {rs!r} (only YaRN)")
    rs = rs or {}
    return DeepseekV2Config(
        n_vocab=hf["vocab_size"],
        n_max_tokens=hf["max_position_embeddings"],
        n_embd=hf["hidden_size"],
        n_intermediate=hf["intermediate_size"],
        n_head=hf["num_attention_heads"],
        n_layer=hf["num_hidden_layers"],
        ftype=GGML_FTYPE_Q4_0,
        layer_norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
        qk_nope_dim=hf["qk_nope_head_dim"],
        qk_rope_dim=hf["qk_rope_head_dim"],
        v_head_dim=hf["v_head_dim"],
        kv_lora_rank=hf["kv_lora_rank"],
        first_k_dense=hf.get("first_k_dense_replace", 0),
        n_experts=hf["n_routed_experts"],
        top_k=hf["num_experts_per_tok"],
        n_shared_experts=hf.get("n_shared_experts") or 0,
        moe_intermediate=hf["moe_intermediate_size"],
        routed_scaling=float(hf.get("routed_scaling_factor", 1.0)),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rope_factor=float(rs.get("factor", 1.0)),
        rope_original_positions=int(rs.get("original_max_position_embeddings",
                                           hf["max_position_embeddings"])),
        rope_beta_fast=float(rs.get("beta_fast") or 32),
        rope_beta_slow=float(rs.get("beta_slow") or 1),
        rope_mscale=float(rs.get("mscale") or 1.0),
        rope_mscale_all_dim=float(rs.get("mscale_all_dim") or 0.0))


def rope_row_order(n_rows: int, first: int, width: int) -> np.ndarray:
    """The identity on ``n_rows`` output rows, but the ``width`` rope rows
    from ``first`` on in the de-interleaved order: even lanes, then odd."""
    order = np.arange(n_rows)
    lanes = np.arange(width)
    order[first:first + width] = first + np.concatenate([lanes[0::2],
                                                         lanes[1::2]])
    return order


def q_row_order(config: DeepseekV2Config) -> np.ndarray:
    """``q_proj``'s rows with each head's rope rows de-interleaved."""
    dh = config.qk_head_dim
    return np.concatenate([
        h * dh + rope_row_order(dh, config.qk_nope_dim, config.qk_rope_dim)
        for h in range(config.n_head)])


def kva_row_order(config: DeepseekV2Config) -> np.ndarray:
    """``kv_a_proj_with_mqa``'s rows with kr's rows de-interleaved."""
    return rope_row_order(config.kv_lora_rank + config.qk_rope_dim,
                          config.kv_lora_rank, config.qk_rope_dim)


def _strip(named: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in named.items():
        k = k[6:] if k.startswith("model.") else k
        if not k.startswith(IGNORED_PREFIXES):
            out[k] = v
    return out


def q4_dense(records: np.ndarray) -> np.ndarray:
    """Q4_0 records [N, K/32, 20] → the dense [N, K] f32 matrix."""
    return dequantize_tpu(_repack(records)).T


def _repack(records: np.ndarray, rows: Optional[np.ndarray] = None
            ) -> QuantTensor:
    """Records [N, K/32, 20] (output rows reordered by ``rows``) → the
    group-local QuantTensor of the logical W[K, N]: a bit-exact repack."""
    if records.dtype != np.uint8 or records.ndim != 3 or \
            records.shape[2] != Q4_RECORD:
        raise ValueError(f"deepseek_v2: a matrix must be stored as Q4_0 "
                         f"records uint8 [N, K/32, {Q4_RECORD}], got "
                         f"{records.dtype} {list(records.shape)}")
    if rows is not None:
        records = records[rows]
    n, nb, _ = records.shape
    return repack_ggml_stream_tpu(np.ascontiguousarray(records).reshape(-1),
                                  (n, nb * QK), GGML_FTYPE_Q4_0)


def _stacked(parts, lead) -> QuantTensor:
    """Preallocated [*lead, K/2, N] and [*lead, K/32, N] filled from the
    QuantTensors ``parts()`` yields in order: no second copy."""
    packed = scales = None
    for i, qt in enumerate(parts):
        if packed is None:
            packed = np.empty((*lead, *qt.packed.shape), np.uint8)
            scales = np.empty((*lead, *qt.scales.shape), np.float32)
        idx = np.unravel_index(i, lead)
        packed[idx] = qt.packed
        scales[idx] = qt.scales
    return QuantTensor(packed=packed, scales=scales)


def params_from_named(named: Dict[str, np.ndarray], config: DeepseekV2Config,
                      phases: Optional[Dict[str, float]] = None) -> dict:
    """The layer-stacked host tree (the module docstring) from the
    checkpoint's tensors (Q4_0 records for the matrices, f32 for the rest),
    with the ``model.`` prefix or without."""
    phases = {} if phases is None else phases
    named = _strip(named)

    def get(name):
        if name not in named:
            raise KeyError(f"missing tensor {name!r} in checkpoint")
        return named[name]

    def f32(name):
        return np.asarray(get(name), dtype=np.float32)

    t0 = time.perf_counter()
    c = config
    n, nd = c.n_layer, c.first_k_dense
    moe = range(nd, n)
    att = "layers.{}.self_attn."
    q_rows, kva_rows = q_row_order(c), kva_row_order(c)

    def mlp_gu(prefix):  # [gate; up] as one product
        return _repack(np.concatenate([get(prefix + "gate_proj.weight"),
                                       get(prefix + "up_proj.weight")]))

    layers = {
        "attn_norm": np.stack([f32(f"layers.{i}.input_layernorm.weight")
                               for i in range(n)]),
        "ffn_norm": np.stack([
            f32(f"layers.{i}.post_attention_layernorm.weight")
            for i in range(n)]),
        "kv_norm": np.stack([f32(att.format(i) + "kv_a_layernorm.weight")
                             for i in range(n)]),
        "q_w": _stacked((_repack(get(att.format(i) + "q_proj.weight"),
                                 q_rows) for i in range(n)), (n,)),
        "kva_w": _stacked((_repack(get(att.format(i)
                                       + "kv_a_proj_with_mqa.weight"),
                                   kva_rows) for i in range(n)), (n,)),
        "kvb_w": _stacked((_repack(get(att.format(i) + "kv_b_proj.weight"))
                           for i in range(n)), (n,)),
        "o_w": _stacked((_repack(get(att.format(i) + "o_proj.weight"))
                         for i in range(n)), (n,)),
        "final_norm": f32("norm.weight"),
    }
    if nd:
        layers["dense_gu_w"] = _stacked(
            (mlp_gu(f"layers.{i}.mlp.") for i in range(nd)), (nd,))
        layers["dense_down_w"] = _stacked(
            (_repack(get(f"layers.{i}.mlp.down_proj.weight"))
             for i in range(nd)), (nd,))
    if c.n_moe_layers:
        e_all = c.n_experts
        order = swiglu_order(c.moe_intermediate)
        exp = "layers.{}.mlp.experts.{}."
        layers["router_w"] = np.stack([
            np.ascontiguousarray(f32(f"layers.{i}.mlp.gate.weight").T)
            for i in moe])
        layers["exp_gu_w"] = _stacked(
            (_repack(np.concatenate([get(exp.format(i, e)
                                         + "gate_proj.weight"),
                                     get(exp.format(i, e)
                                         + "up_proj.weight")]), order)
             for i in moe for e in range(e_all)), (c.n_moe_layers, e_all))
        layers["exp_down_w"] = _stacked(
            (_repack(get(exp.format(i, e) + "down_proj.weight"))
             for i in moe for e in range(e_all)), (c.n_moe_layers, e_all))
        if c.n_shared_experts:
            layers["shared_gu_w"] = _stacked(
                (mlp_gu(f"layers.{i}.mlp.shared_experts.") for i in moe),
                (c.n_moe_layers,))
            layers["shared_down_w"] = _stacked(
                (_repack(get(f"layers.{i}.mlp.shared_experts."
                             "down_proj.weight")) for i in moe),
                (c.n_moe_layers,))
    phases["repack"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    emb = {"word": q4_dense(get("embed_tokens.weight"))}
    phases["emb_dequant"] = round(time.perf_counter() - t0, 3)
    return {"embeddings": emb, "layers": layers}


class DeepseekV2Model(nn.Module):
    """The decoder up to its final norm, from the layer-stacked device tree
    (:func:`bert_tpu_torch.params.params_to_torch` of
    :func:`params_from_named`'s tree). Same ``hidden`` call as the other
    encoder classes, so ``model.bert_forward`` runs it; its attention is
    causal, so it pools at the last token and takes no packed rows
    (``causal``). Its experts are Q4_0 alone, so it has no int8 regime
    (``int8``), and its kernels on the card compute in bf16
    (``kernel_dtypes``). Tokens routed to each expert of each MoE layer are
    counted on the device in ``expert_tokens`` [n_moe_layers, E]."""

    causal = True
    int8 = False
    kernel_dtypes = (torch.bfloat16,)

    def __init__(self, params: Dict[str, Dict[str, object]],
                 config: DeepseekV2Config, tp_group=None):
        super().__init__()
        if tp_group is not None:
            raise NotImplementedError(
                "DeepSeek-V2 runs on one device: tensor-parallel shards of "
                "it are not supported")
        self.config = config
        device = params["embeddings"]["word"].device
        self.embeddings = _Weights()
        self.embeddings._register(params["embeddings"])
        layers = params["layers"]
        nd = config.first_k_dense
        moe_keys = ("router_w", "exp_gu_w", "exp_down_w", "shared_gu_w",
                    "shared_down_w")
        self.layers = nn.ModuleList()
        for i in range(config.n_layer):
            lw = _Weights()
            own = {k: layer_slice(v, i) for k, v in layers.items()
                   if k in ("attn_norm", "ffn_norm", "kv_norm", "q_w",
                            "kva_w", "kvb_w", "o_w")}
            if i < nd:
                own.update({k: layer_slice(layers[k], i)
                            for k in ("dense_gu_w", "dense_down_w")})
            else:
                own.update({k: layer_slice(layers[k], i - nd)
                            for k in moe_keys if k in layers})
            lw._register(own)
            self.layers.append(lw)
        self.register_buffer("final_norm", layers["final_norm"])
        self.register_buffer("expert_tokens", torch.zeros(
            (config.n_moe_layers, config.n_experts), dtype=torch.int64,
            device=device))
        inv_freq = yarn_inv_freq(config.qk_rope_dim, config.rope_theta,
                                 config.rope_factor,
                                 config.rope_original_positions,
                                 config.rope_beta_fast,
                                 config.rope_beta_slow, device=device)
        cos, sin = rope_tables(config.rope_theta, config.qk_rope_dim,
                               config.n_max_tokens, device, inv_freq)
        # the published code scales cos and sin by m(factor, mscale) /
        # m(factor, mscale_all_dim): 1 where the two are equal, as published
        m = (yarn_mscale(config.rope_factor, config.rope_mscale)
             / yarn_mscale(config.rope_factor, config.rope_mscale_all_dim))
        if m != 1.0:
            cos, sin = cos * m, sin * m
        self.register_buffer("rope_cos", cos)
        self.register_buffer("rope_sin", sin)

    def _norm(self, x, scale, plain):
        eps = self.config.layer_norm_eps
        if plain:
            return rms_norm_plain(x, scale, eps)
        return rms_norm(x, scale, eps=eps)

    def _add_norm(self, y, x, scale, plain):
        eps = self.config.layer_norm_eps
        if plain:
            return add_rms_norm_plain(y, x, scale, eps)
        return add_rms_norm(y, x, scale, eps=eps)

    def _attention(self, a, w, t, plain, use_kernels):
        c = self.config
        dims = dict(nope=c.qk_nope_dim, rope=c.qk_rope_dim)
        heads = dict(t=t, n_head=c.n_head, rank=c.kv_lora_rank)
        q = dense(a, w("q_w"), use_kernels=use_kernels)
        kva = dense(a, w("kva_w"), use_kernels=use_kernels)
        cn = self._norm(kva[:, :c.kv_lora_rank], w("kv_norm"), plain)
        kvb = dense(cn, w("kvb_w"), use_kernels=use_kernels)
        rope = rope_mla_plain if plain else rope_mla
        q, kva = rope(q, kva, self.rope_cos, self.rope_sin, **heads, **dims)
        attn = causal_attention_plain if plain else causal_attention
        ctx = attn(q, kva, kvb, scale=c.softmax_scale, dv=c.v_head_dim,
                   **heads, **dims)
        return dense(ctx, w("o_w"), f32_out=True, use_kernels=use_kernels)

    def _swiglu(self, h, gu_w, down_w, use_kernels):
        gu = dense(h, gu_w, use_kernels=use_kernels)
        width = gu.shape[-1] // 2
        act = F.silu(gu[:, :width]) * gu[:, width:]
        return dense(act, down_w, f32_out=True, use_kernels=use_kernels)

    def _moe(self, h, w, j, plain, use_kernels):
        c = self.config
        logits = torch.matmul(h.float(), w("router_w"))
        routing = (moe_route_plain if plain else moe_route)(
            logits, c.top_k, c.routed_scaling, self.expert_tokens[j])
        matmul = expert_matmul_plain if plain else expert_matmul
        act = matmul(h, w("exp_gu_w"), routing, gather=True, swiglu=True)
        y = matmul(act, w("exp_down_w"), routing, gather=False,
                   swiglu=False)
        if c.n_shared_experts:
            shared = self._swiglu(h, w("shared_gu_w"), w("shared_down_w"),
                                  use_kernels)
        else:
            shared = torch.zeros(h.shape, dtype=torch.float32,
                                 device=h.device)
        return (moe_combine_plain if plain else moe_combine)(shared, y,
                                                             routing)

    def hidden(self, token_ids: torch.Tensor, mask_bias: torch.Tensor,
               position_ids: Optional[torch.Tensor] = None, *,
               dtype: torch.dtype, use_kernels: Optional[bool] = None,
               remat: bool = False) -> torch.Tensor:
        """``BertModel.hidden``'s call: the final norm's output [B, T, D]
        of right-padded rows at positions 0..T-1. The attention is causal,
        so a real token sees real tokens alone and ``mask_bias`` is not
        read; packed rows (``position_ids``) are refused. The model is
        served, not trained, so ``remat`` changes nothing."""
        if position_ids is not None:
            raise NotImplementedError(
                "DeepSeek-V2 takes bucketed rows only: its causal attention "
                "has no per-segment form")
        b, t = token_ids.shape
        d = self.config.n_embd
        x = self.embeddings.w("word")[token_ids].to(dtype).reshape(b * t, d)
        plain = _plain(use_kernels, x)
        a = self._norm(x, self.layers[0].w("attn_norm"), plain)
        nd = self.config.first_k_dense
        for i, layer in enumerate(self.layers):
            w = layer.w
            y = self._attention(a, w, t, plain, use_kernels)
            x, h = self._add_norm(y, x, w("ffn_norm"), plain)
            if i < nd:
                y = self._swiglu(h, w("dense_gu_w"), w("dense_down_w"),
                                 use_kernels)
            else:
                y = self._moe(h, w, i - nd, plain, use_kernels)
            nxt = (self.layers[i + 1].w("attn_norm")
                   if i + 1 < len(self.layers) else self.final_norm)
            x, a = self._add_norm(y, x, nxt, plain)
        return a.reshape(b, t, d)

    def attention_launches(self):
        """Attention launches of one batch by kind, for
        ``BertTorch.stats()["attention"]``: one causal a layer."""
        return {"causal": self.config.n_layer}

    def expert_counts(self) -> Dict[str, list]:
        """Tokens routed to each expert of each MoE layer so far (read from
        the device): layer index → [E] counts."""
        counts = self.expert_tokens.cpu().tolist()
        nd = self.config.first_k_dense
        return {str(nd + j): row for j, row in enumerate(counts)}

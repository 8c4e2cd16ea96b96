"""ModernBERT encoders (answerdotai/ModernBERT-base's architecture, as
Alibaba-NLP/gte-modernbert-base ships it) on the port's path.

The forward, from transformers' ``modeling_modernbert.py``:

    x = LN_emb(E[ids])                        (no position table)
    for each layer l:
        a = x if l == 0 else LN_attn_l(x)     (layer 0's attn_norm: Identity)
        q, k, v = a · Wqkv; RoPE on q and k   (rotate-half)
        x = x + Wo · softmax(q kᵀ/√dh + mask) v
        u, g = chunk(LN_mlp_l(x) · Wi, 2)
        x = x + Wo_mlp · (gelu(u) ⊙ g)        (exact erf GELU)
    h = LN_final(x)

Layers l with l % global_attn_every == 0 attend over every key with RoPE θ
``rope_theta_global``; the others over the keys within local_window // 2
positions (inclusive) with θ ``rope_theta_local``. No projection or norm
has a bias.

The params tree has BERT's shape: ``{"embeddings": {word, ln_scale},
"layers": {qkv_w, o_w, ln_mlp_scale, ff_i_w, ff_o_w, ln_out_scale}}``,
matmul weights ``W[in, out]`` (dense, QuantTensor or, in the int8 tree,
Int8Tensor) stacked over the layers. ``qkv_w``'s columns are
head-interleaved as BERT's (``params.py``); ``ff_i_w``'s first
``n_intermediate`` columns are GeGLU's input, the rest its gate. Layer l's
``ln_out_scale`` is the norm that follows it: layer l+1's attn_norm, or
the final norm after the last layer. So each residual add meets the next
LayerNorm, and runs with it as one launch (the LayerNorm's add form), and
layer 0's missing attn_norm is no entry at all.

The model shares BERT's ops: ``model.dense`` (Q4, dense or W8A8
products), the fused attention's RoPE and band forms, the LayerNorm and
its add form, and the pooled forwards (``model.bert_forward`` and
``bert_forward_packed``, CLS or mean), which call :meth:`hidden`. GeGLU's
elementwise ops are plain torch ops in the compute dtype. RoPE's cos and
sin tables, one pair per θ, are built once on the device. In the int8
regime every product quantizes its input on its own: BERT's folding of
the codes into its LayerNorms and of GELU into FFN-up does not apply to
this block.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .model import _plain, _Weights, dense, layer_norm, layer_slice
from .ops.fused_attention import (attention_plain, fused_qkv_attention,
                                  rope_qkv, rope_qkv_plain, rope_tables)
from .ops.layer_norm import add_layer_norm_plain, fused_add_layer_norm
from .params import ModernBertConfig
from .quant import GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1

# tensors of a checkpoint that the encoder does not use: the MaskedLM head
IGNORED_PREFIXES = ("head.", "decoder.")


def config_from_hf(hf: dict, ftype: int = 0) -> ModernBertConfig:
    """The config of a ``config.json`` with ``model_type`` "modernbert"."""
    act = hf.get("hidden_activation", "gelu")
    if act != "gelu":
        raise ValueError(f"modernbert: hidden_activation {act!r} (only "
                         "'gelu', exact erf, is supported)")
    for key in ("attention_bias", "mlp_bias", "norm_bias"):
        if hf.get(key):
            raise ValueError(f"modernbert: {key} is set; the port runs "
                             "ModernBERT without biases, as published")
    local_theta = hf.get("local_rope_theta")
    return ModernBertConfig(
        n_vocab=hf["vocab_size"],
        n_max_tokens=hf["max_position_embeddings"],
        n_embd=hf["hidden_size"],
        n_intermediate=hf["intermediate_size"],
        n_head=hf["num_attention_heads"],
        n_layer=hf["num_hidden_layers"],
        ftype=ftype,
        layer_norm_eps=float(hf.get("norm_eps", 1e-5)),
        global_attn_every=int(hf.get("global_attn_every_n_layers", 3)),
        local_window=int(hf.get("local_attention", 128)),
        rope_theta_global=float(hf.get("global_rope_theta", 160000.0)),
        rope_theta_local=float(hf.get("global_rope_theta", 160000.0)
                               if local_theta is None else local_theta))


def qkv_row_order(config: ModernBertConfig) -> np.ndarray:
    """Row permutation of ``Wqkv`` [3D, D] (stacked q; k; v, each head's
    dh rows in turn) into the head-interleaved order: for head h, its q,
    k and v rows. A permutation of output rows moves whole Q4 groups
    (they lie along the input), so it is bit-exact before or after
    quantizing."""
    d, h, dh = config.n_embd, config.n_head, config.d_head
    return (np.arange(3 * d).reshape(3, h, dh).transpose(1, 0, 2)
            .reshape(-1))


def _strip(named: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Names as ``ModernBertModel`` writes them: ``model.`` (a MaskedLM
    checkpoint's prefix) removed, the MaskedLM head dropped."""
    out = {}
    for k, v in named.items():
        k = k[6:] if k.startswith("model.") else k
        if not k.startswith(IGNORED_PREFIXES):
            out[k] = v
    return out


def params_from_named(named: Dict[str, np.ndarray], config: ModernBertConfig,
                      quantize_ftype: Optional[int] = None,
                      phases: Optional[Dict[str, float]] = None,
                      dtype=np.float32) -> dict:
    """The layer-stacked host tree (the module docstring) from a
    checkpoint's tensors in torch layout (``[out, in]``). ``quantize_ftype``
    Q4_0 / Q4_1 quantizes the four matmul weights of every layer; the
    embedding table stays dense."""
    from .quant import quantize_tensor_tpu, stack_quant

    phases = {} if phases is None else phases
    named = _strip(named)

    def get(name):
        if name not in named:
            raise KeyError(f"missing tensor {name!r} in checkpoint")
        return np.asarray(named[name], dtype=np.float32)

    if "layers.0.attn_norm.weight" in named:
        raise ValueError("modernbert: layer 0 has an attn_norm; the "
                         "architecture's layer 0 takes the embeddings as "
                         "they are")
    t0 = time.perf_counter()
    n = config.n_layer
    order = qkv_row_order(config)
    per_layer = {
        "qkv_w": [get(f"layers.{i}.attn.Wqkv.weight")[order].T
                  for i in range(n)],
        "o_w": [get(f"layers.{i}.attn.Wo.weight").T for i in range(n)],
        "ff_i_w": [get(f"layers.{i}.mlp.Wi.weight").T for i in range(n)],
        "ff_o_w": [get(f"layers.{i}.mlp.Wo.weight").T for i in range(n)],
    }
    norms = [f"layers.{i}.attn_norm.weight" for i in range(1, n)]
    layers = {
        "ln_mlp_scale": np.stack([get(f"layers.{i}.mlp_norm.weight")
                                  for i in range(n)]),
        "ln_out_scale": np.stack([get(k) for k in norms]
                                 + [get("final_norm.weight")]),
    }
    emb = {"word": get("embeddings.tok_embeddings.weight").astype(dtype),
           "ln_scale": get("embeddings.norm.weight")}
    phases["relayout"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    if quantize_ftype in (GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1):
        for key, ws in per_layer.items():
            layers[key] = stack_quant([quantize_tensor_tpu(
                np.ascontiguousarray(w), quantize_ftype) for w in ws])
        phases["quantize"] = round(time.perf_counter() - t0, 3)
    else:
        for key, ws in per_layer.items():
            layers[key] = np.stack(ws).astype(dtype)
    return {"embeddings": emb, "layers": layers}


class ModernBertModel(nn.Module):
    """The encoder, from the layer-stacked device tree
    (:func:`bert_tpu_torch.params.params_to_torch` of
    :func:`params_from_named`'s tree, or its int8 tree). Same ``embed`` /
    ``encode`` / ``hidden`` roles as
    :class:`bert_tpu_torch.model.BertModel`, with the rows' positions
    passed to ``encode`` for RoPE, so ``model.bert_forward`` and
    ``bert_forward_packed`` run it."""

    def __init__(self, params: Dict[str, Dict[str, object]],
                 config: ModernBertConfig, tp_group=None):
        super().__init__()
        if tp_group is not None:
            raise NotImplementedError(
                "ModernBERT runs on one device: tensor-parallel shards of "
                "it are not supported")
        self.config = config
        device = params["embeddings"]["word"].device
        self.embeddings = _Weights()
        self.embeddings._register(params["embeddings"])
        layers = params["layers"]
        self.layers = nn.ModuleList()
        for i in range(config.n_layer):
            lw = _Weights()
            lw._register({k: layer_slice(v, i) for k, v in layers.items()})
            self.layers.append(lw)
        # the norms have no bias: their kernel adds a zero one
        self.register_buffer("zero_bias", torch.zeros(
            config.n_embd, dtype=torch.float32, device=device))
        # RoPE's tables, one pair per θ, up to the model's positions
        self._thetas = sorted({config.rope_theta(i)
                               for i in range(config.n_layer)})
        for j, theta in enumerate(self._thetas):
            cos, sin = rope_tables(theta, config.d_head,
                                   config.n_max_tokens, device)
            self.register_buffer(f"rope_cos_{j}", cos)
            self.register_buffer(f"rope_sin_{j}", sin)

    def rope(self, layer: int):
        """Layer ``layer``'s (cos, sin) tables."""
        j = self._thetas.index(self.config.rope_theta(layer))
        return getattr(self, f"rope_cos_{j}"), getattr(self, f"rope_sin_{j}")

    def embed(self, token_ids: torch.Tensor, dtype: torch.dtype, *,
              use_kernels: Optional[bool] = None) -> torch.Tensor:
        x = self.embeddings.w("word")[token_ids].to(dtype)
        return layer_norm(x, self.embeddings.w("ln_scale"), self.zero_bias,
                          self.config.layer_norm_eps,
                          use_kernels=use_kernels)

    def _add_norm(self, y, x, scale, use_kernels):
        """(x + y, LN(x + y)): the LayerNorm's add form."""
        eps = self.config.layer_norm_eps
        if _plain(use_kernels, x):
            return add_layer_norm_plain(y, x, scale, self.zero_bias, eps)
        return fused_add_layer_norm(y, x, scale, self.zero_bias, eps=eps)

    def _attention(self, qkv, mask_bias, layer, positions, use_kernels):
        """RoPE on q and k (on the card in place in qkv), then the
        attention, full or in the layer's band."""
        c = self.config
        heads = dict(n_head=c.n_head, d_head=c.d_head)
        kw = dict(heads, scale=1.0 / (c.d_head ** 0.5),
                  window=c.window(layer))
        if _plain(use_kernels, qkv):
            qkv = rope_qkv_plain(qkv, *self.rope(layer), positions, **heads)
            return attention_plain(qkv, mask_bias, **kw)
        qkv = rope_qkv(qkv, *self.rope(layer), positions, **heads)
        return fused_qkv_attention(qkv, mask_bias, **kw)

    def encode(self, x: torch.Tensor, mask_bias: torch.Tensor, *,
               positions: Optional[torch.Tensor] = None,
               use_kernels: Optional[bool] = None) -> torch.Tensor:
        """Embeddings [B, T, D] → the final norm's output [B, T, D].
        ``positions`` [B, T] (None: 0..T-1) are RoPE's."""
        if positions is not None:
            positions = positions.to(torch.int32)
        a = x  # layer 0 takes the embeddings as they are
        half = self.config.n_intermediate
        for i, layer in enumerate(self.layers):
            w = layer.w
            qkv = dense(a, w("qkv_w"), use_kernels=use_kernels)
            ctx = self._attention(qkv, mask_bias, i, positions, use_kernels)
            y = dense(ctx, w("o_w"), f32_out=True, use_kernels=use_kernels)
            x, h = self._add_norm(y, x, w("ln_mlp_scale"), use_kernels)
            ug = dense(h, w("ff_i_w"), use_kernels=use_kernels)
            act = F.gelu(ug[..., :half]) * ug[..., half:]
            y = dense(act, w("ff_o_w"), f32_out=True, use_kernels=use_kernels)
            x, a = self._add_norm(y, x, w("ln_out_scale"), use_kernels)
        return a

    def hidden(self, token_ids: torch.Tensor, mask_bias: torch.Tensor,
               position_ids: Optional[torch.Tensor] = None, *,
               dtype: torch.dtype, use_kernels: Optional[bool] = None,
               remat: bool = False) -> torch.Tensor:
        """``BertModel.hidden``'s call: the final norm's output [B, T, D],
        RoPE at ``position_ids`` (None: 0..T-1). Packed rows' positions
        restart at each segment, and the band is counted in rows, which
        within a segment are its positions. The model is served, not
        trained, so ``remat`` changes nothing."""
        x = self.embed(token_ids, dtype, use_kernels=use_kernels)
        return self.encode(x, mask_bias, positions=position_ids,
                           use_kernels=use_kernels)

    def attention_launches(self):
        """Attention launches of one batch by kind, full and band: times
        the batch counts of each shape, ``BertTorch.stats()["attention"]``."""
        n_global = sum(self.config.is_global(i)
                       for i in range(self.config.n_layer))
        return {"full": n_global, "band": self.config.n_layer - n_global}


"""Batched, masked BERT encoder forward in PyTorch.

Counterpart of ``bert_tpu/model.py``. The layer-stacked parameter tree
(bert_tpu_torch/params.py) becomes a :class:`BertModel`: an embeddings
module and an ``nn.ModuleList`` of :class:`EncoderLayer` in place of
``lax.scan``. Each layer runs four matmuls — Q4 dequant-matmuls
(ops/q4_matmul.py) for quantized weights, W8A8 int8 products
(ops/int8_matmul.py) for the int8 tree, plain products for dense ones,
as bert_tpu leaves those to XLA — one attention and two fused
bias+residual LayerNorms (ops/layer_norm.py); the embedding LayerNorm is
one more. Attention takes one of bert_tpu's two routes: the fused QKV
kernel (ops/fused_attention.py) where :func:`fused_route` finds it an
instance, else the per-(batch, head) kernel (ops/attention.py) on q, k, v
split out of the fused projection. The embedding gather, GELU (exact
erf), the mask bias, pooling and the head split/merge copies are plain
torch ops. On CPU tensors every op takes its plain version, which mirrors
the JAX package's jnp path, so the two packages compute the same thing
there.

Tensor parallelism (``tp_axis``) and rematerialization (``remat``) are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .ops.common import NEG_INF
from .ops.attention import multi_head_attention
from .ops.fused_attention import fused_qkv_attention, fused_route
from .ops.int8_matmul import Int8Weight, int8_matmul
from .ops.layer_norm import fused_layer_norm
from .ops.q4_matmul import q4_matmul
from .params import BertConfig
from .quant import QuantTensor


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None, *,
          f32_out: bool = False) -> torch.Tensor:
    """``x @ W (+ b)`` where W is a dense [K, N] tensor, a QuantTensor or
    an Int8Weight (the W8A8 path). The f32 product is cast to x's dtype
    first and the bias added after, in x's dtype, as
    ``bert_tpu.model.dense`` does. ``f32_out`` (no bias)
    hands back the f32 product unrounded, for a consumer that rounds it
    itself: the LayerNorm's f32-input form saves the cast's launch."""
    if f32_out and b is not None:
        raise ValueError("dense: f32_out takes no bias")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if isinstance(w, QuantTensor):
        y = q4_matmul(x2, w)
        n = w.n
    elif isinstance(w, Int8Weight):
        y = int8_matmul(x2, w)
        n = w.n
    else:
        y = torch.matmul(x2.float(), w.to(x.dtype).float())
        n = w.shape[-1]
    if not f32_out:
        y = y.to(x.dtype)
    y = y.reshape(*shape[:-1], n)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


class _Weights(nn.Module):
    """Registers a dict of tensors / QuantTensors / Int8Weights as buffers
    and hands them back by name (``self.w("qkv_w")``)."""

    def _register(self, tensors: Dict[str, object]) -> None:
        self._quant = {}
        self._int8 = {}  # key → logical K
        for key, v in tensors.items():
            if isinstance(v, QuantTensor):
                self._quant[key] = v.mins is not None
                self.register_buffer(f"{key}__packed", v.packed)
                self.register_buffer(f"{key}__scales", v.scales)
                self.register_buffer(f"{key}__mins", v.mins)
            elif isinstance(v, Int8Weight):
                self._int8[key] = v.k
                self.register_buffer(f"{key}__w_nk", v.w_nk)
                self.register_buffer(f"{key}__scale", v.scale)
            else:
                self.register_buffer(key, v)

    def w(self, key: str):
        if key in self._quant:
            return QuantTensor(packed=getattr(self, f"{key}__packed"),
                               scales=getattr(self, f"{key}__scales"),
                               mins=getattr(self, f"{key}__mins"))
        if key in self._int8:
            return Int8Weight(w_nk=getattr(self, f"{key}__w_nk"),
                              scale=getattr(self, f"{key}__scale"),
                              k=self._int8[key])
        return getattr(self, key)


class Embeddings(_Weights):
    """Token + token-type(0) + position embeddings, then LayerNorm
    (bert.cpp:784-814; ``bert_tpu.model.embed``)."""

    def __init__(self, emb: Dict[str, torch.Tensor], config: BertConfig):
        super().__init__()
        self.config = config
        self._register(emb)

    def forward(self, token_ids: torch.Tensor, dtype: torch.dtype,
                position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        # the add order word → token_type → position, in the compute dtype
        t = token_ids.shape[-1]
        x = self.word[token_ids].to(dtype)
        x = x + self.token_type[0].to(dtype)
        if position_ids is None:
            x = x + self.position[:t].to(dtype)
        else:
            x = x + self.position[position_ids].to(dtype)
        return fused_layer_norm(x, self.ln_scale, self.ln_bias,
                                eps=self.config.layer_norm_eps)


class EncoderLayer(_Weights):
    """One transformer encoder block (bert.cpp:816-903;
    ``bert_tpu.model.encoder_layer``)."""

    def __init__(self, lp: Dict[str, object], config: BertConfig):
        super().__init__()
        self.config = config
        self._register(lp)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor
                ) -> torch.Tensor:
        cfg = self.config
        dh = cfg.d_head
        b, t, _ = x.shape
        # ONE fused head-interleaved QKV matmul (params.py)
        qkv = dense(x, self.w("qkv_w"), self.qkv_b)
        n_head = qkv.shape[-1] // (3 * dh)
        scale = 1.0 / (dh ** 0.5)  # bert.cpp:848
        # bert_tpu/model.py:135-148, with two departures: the per-(b, h)
        # kernel runs at every T (bert_tpu takes _mha_jnp below T = 256)
        # and for packed rows' pairwise bias (bert_tpu takes _mha_jnp),
        # since on the card the port has no plain path
        if fused_route(t, n_head, dh, qkv.dtype,
                       pairwise=mask_bias.dim() == 3):
            ctx = fused_qkv_attention(qkv, mask_bias, n_head=n_head,
                                      d_head=dh, scale=scale)
        else:
            q5 = qkv.view(b, t, n_head, 3, dh).permute(0, 2, 3, 1, 4)
            q, k, v = (q5[:, :, i].contiguous() for i in range(3))
            ctx = multi_head_attention(q, k, v, mask_bias, scale=scale)
            ctx = ctx.permute(0, 2, 1, 3).reshape(b, t, n_head * dh)
        # The two projections hand the LayerNorm their f32 products, which
        # it rounds to x's dtype first: bit for bit bert_tpu's cast, then
        # LN, without the cast's own launch. When tensor parallelism is
        # ported (ROADMAP.md A7), each product's all-reduce falls here,
        # between the product and the LayerNorm (bert_tpu/model.py:150-161).
        att_out = dense(ctx, self.w("o_w"), f32_out=True)
        x = fused_layer_norm(att_out, self.ln_att_scale, self.ln_att_bias,
                             eps=cfg.layer_norm_eps, residual=x,
                             pre_bias=self.o_b,
                             out_dtype=x.dtype)  # residual 1, bert.cpp:859-875
        h = dense(x, self.w("ff_i_w"), self.ff_i_b)
        h = F.gelu(h, approximate="tanh" if cfg.gelu_approx else "none")
        ff_out = dense(h, self.w("ff_o_w"), f32_out=True)
        return fused_layer_norm(ff_out, self.ln_out_scale, self.ln_out_bias,
                                eps=cfg.layer_norm_eps, residual=x,
                                pre_bias=self.ff_o_b,
                                out_dtype=x.dtype)  # residual 2, :885-901


class BertModel(nn.Module):
    """The encoder, built from a layer-stacked device params tree
    (:func:`bert_tpu_torch.params.params_to_torch`). Layer l's weights are
    views ``[l]`` of the stacked tensors, so building it copies nothing:
    two models built from trees that share tensors (the engine's Q4 and
    int8 trees share everything but the matmul weights) share their
    device memory."""

    def __init__(self, params: Dict[str, Dict[str, object]],
                 config: BertConfig):
        super().__init__()
        self.config = config
        self.embeddings = Embeddings(params["embeddings"], config)
        layers = params["layers"]

        def layer_slice(v, i):
            if isinstance(v, QuantTensor):
                return QuantTensor(packed=v.packed[i], scales=v.scales[i],
                                   mins=None if v.mins is None else v.mins[i])
            if isinstance(v, Int8Weight):
                return Int8Weight(w_nk=v.w_nk[i], scale=v.scale[i], k=v.k)
            return v[i]

        self.layers = nn.ModuleList(
            EncoderLayer({k: layer_slice(v, i) for k, v in layers.items()},
                         config)
            for i in range(config.n_layer))

    def encode(self, x: torch.Tensor, mask_bias: torch.Tensor
               ) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask_bias)
        return x


def segment_attention_bias(segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, T] segment ids (0 = padding) → [B, T, T] additive attention bias:
    0 where query and key share a non-padding segment, NEG_INF elsewhere.
    Makes packed rows exactly block-diagonal."""
    same = segment_ids[:, :, None] == segment_ids[:, None, :]
    key_valid = (segment_ids > 0)[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=segment_ids.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32,
                     device=segment_ids.device)
    return torch.where(same & key_valid, zero, neg)


def _l2(pooled: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(torch.square(pooled), dim=-1, keepdim=True))
    return pooled / torch.clamp(norm, min=1e-12)


def mean_pool_l2(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean pool + L2 normalize, in f32 (bert.cpp:906-913)."""
    xf = x.float()
    m = mask.float()[..., None]
    denom = torch.clamp(torch.sum(m, dim=-2), min=1.0)
    return _l2(torch.sum(xf * m, dim=-2) / denom)


def cls_pool_l2(x: torch.Tensor) -> torch.Tensor:
    """[CLS]-token pool + L2 normalize, in f32. Every row starts with
    [CLS], so position 0 is valid under any mask."""
    return _l2(x[..., 0, :].float())


def _segment_hits(segment_ids: torch.Tensor, n_segments: int
                  ) -> torch.Tensor:
    slots = torch.arange(1, n_segments + 1, device=segment_ids.device)
    return segment_ids[:, :, None] == slots[None, None]  # [B, T, S]


def segment_mean_pool_l2(x: torch.Tensor, segment_ids: torch.Tensor,
                         n_segments: int) -> torch.Tensor:
    """Per-segment masked mean pool + L2 normalize, in f32: x [B, T, D],
    segment_ids [B, T] (0 = padding, 1..n_segments) → [B, S, D]; empty
    slots come out as zero vectors."""
    xf = x.float()
    oh = _segment_hits(segment_ids, n_segments).float()
    sums = torch.einsum("bts,btd->bsd", oh, xf)
    counts = torch.sum(oh, dim=1)[..., None]
    return _l2(sums / torch.clamp(counts, min=1.0))


def segment_cls_pool_l2(x: torch.Tensor, segment_ids: torch.Tensor,
                        n_segments: int) -> torch.Tensor:
    """Per-segment [CLS] pool + L2 normalize for packed rows: each
    segment's first token is its [CLS]. Empty slots → zero vectors."""
    xf = x.float()
    hit = _segment_hits(segment_ids, n_segments)
    first = torch.argmax(hit.to(torch.int32), dim=1)  # first True per slot
    cls = torch.take_along_dim(xf, first[:, :, None], dim=1)
    present = torch.any(hit, dim=1)[..., None]
    return _l2(torch.where(present, cls, torch.zeros_like(cls)))


def _check_pooling(pooling: str) -> None:
    if pooling not in ("mean", "cls"):
        raise ValueError(f"pooling must be 'mean' or 'cls', got {pooling!r}")


def bert_forward(model: BertModel, token_ids: torch.Tensor,
                 mask: torch.Tensor, *,
                 compute_dtype: torch.dtype = torch.float32,
                 pooling: str = "mean") -> torch.Tensor:
    """token_ids [B, T] int, mask [B, T] → L2-normalized embeddings
    [B, n_embd] f32 (``bert_tpu.model.bert_forward``)."""
    _check_pooling(pooling)
    x = model.embeddings(token_ids, compute_dtype)
    # 0 for real tokens, NEG_INF for padding
    mask_bias = (mask.float() - 1.0) * (-NEG_INF)
    x = model.encode(x, mask_bias)
    if pooling == "cls":
        return cls_pool_l2(x)
    return mean_pool_l2(x, mask)


def bert_forward_packed(model: BertModel, token_ids: torch.Tensor,
                        segment_ids: torch.Tensor,
                        position_ids: torch.Tensor, *, n_segments: int,
                        compute_dtype: torch.dtype = torch.float32,
                        pooling: str = "mean") -> torch.Tensor:
    """Packed-row forward: token_ids/segment_ids/position_ids [B, T] →
    per-segment L2-normalized embeddings [B, n_segments, n_embd] f32
    (``bert_tpu.model.bert_forward_packed``): per-segment positions,
    block-diagonal attention, per-segment pooling."""
    _check_pooling(pooling)
    x = model.embeddings(token_ids, compute_dtype, position_ids=position_ids)
    mask_bias = segment_attention_bias(segment_ids)
    x = model.encode(x, mask_bias)
    if pooling == "cls":
        return segment_cls_pool_l2(x, segment_ids, n_segments)
    return segment_mean_pool_l2(x, segment_ids, n_segments)

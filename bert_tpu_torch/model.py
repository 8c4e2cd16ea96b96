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

:func:`bert_forward` and :func:`bert_forward_packed` are the pooled
forwards of every encoder class, ModernBERT's (``modernbert.py``) and
DeepSeek-V2's (``deepseek_v2.py``, bucketed rows only) included: each
builds the mask bias, calls the model's ``hidden`` (the embeddings, then
the layers) and pools. ``hidden`` takes the rows'
positions, which BERT's position table reads and ModernBERT's RoPE. The
kernel wrappers count their launches in the op layer's registry
(``ops.common.COUNTERS``).

``use_kernels`` is bert_tpu's ``use_pallas``: None (the default, what
serving uses) launches the kernels for CUDA tensors and takes the plain
versions for CPU ones; False takes the plain versions on any device, and
attention then takes the per-(batch, head) route, as bert_tpu's does when
``fused_short`` is off; True asks for the kernels and raises for a tensor
that is not on the card. The kernels have no backward, so training runs
the plain versions (``use_kernels=False``), as bert_tpu trains on its jnp
path; a kernel asked for on a tensor that autograd tracks raises rather
than cut the gradient off. :class:`TrainableBertModel` holds the weights
as ``nn.Parameter``s, layer-stacked as in bert_tpu's tree, and
``remat=True`` recomputes each layer's activations in the backward
(``torch.utils.checkpoint``) instead of keeping them.

The int8 regime (every matmul weight an :class:`Int8Weight`, as
``params_to_int8`` makes the tree) folds the quantization of the QKV and
FFN-up inputs into the op that makes them: the embedding LayerNorm and
each layer's two LayerNorms take their codes form (the codes of their
rounded output, for the next QKV and this layer's FFN-up product; the
last layer's writes none), and FFN-up takes the product's form (c) (bias
and GELU in its epilogue). The codes travel beside the activation as a
:class:`Folded`. The attention context and FFN-up's output are quantized
on their own. The same structure runs on the CPU through the plain
versions, bit for bit the unfolded ops.

Tensor parallelism (bert_tpu's ``tp_axis``): a model built from one
rank's Megatron shard (parallel/sharding.py) carries its mesh's ``model``
process group, ``tp_group``. Its QKV and FFN-up weights hold whole heads
and columns, so the local head count follows from the shard width; the
attention-output and FFN-down products are partial sums, all-reduced
over ``model`` before their LayerNorms: two all-reduces a layer, as
bert_tpu's two psums. As bert_tpu does, each partial product is rounded
to the compute dtype and the rounded partials are summed. In training the
all-reduces are Megatron's *f* and *g* operators
(parallel/collectives.py).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .ops.common import NEG_INF
from .ops.attention import _mha_plain, multi_head_attention
from .ops.fused_attention import fused_qkv_attention, fused_route
from .ops.int8_matmul import (Int8Weight, int8_matmul, int8_matmul_codes,
                              int8_matmul_codes_plain, int8_matmul_gelu,
                              int8_matmul_gelu_plain, int8_matmul_plain,
                              quantize_activations_i8,
                              quantize_activations_i8_plain)
from .ops.layer_norm import (fused_layer_norm, fused_layer_norm_codes,
                             layer_norm_codes_plain, layer_norm_plain)
from .ops.q4_matmul import q4_matmul, q4_matmul_plain
from .parallel.collectives import copy_to_model, reduce_from_model
from .params import BertConfig, ModernBertConfig
from .quant import QuantTensor


class Folded(NamedTuple):
    """An activation x [..., D] in the int8 regime with the W8A8 codes of
    its rows, as its producer wrote them: ``codes`` [M, Kp] int8 and
    ``sx`` [M] f32, M = x.numel() / D."""
    x: torch.Tensor
    codes: torch.Tensor
    sx: torch.Tensor


Codes = Tuple[torch.Tensor, torch.Tensor]  # (codes [M, Kp], sx [M])


def _plain(use_kernels: Optional[bool], x: torch.Tensor) -> bool:
    """Whether an op on ``x`` takes its plain version rather than its
    wrapper (which launches the kernel for a CUDA tensor and takes the
    plain version for a CPU one). False → plain; True on a tensor not on
    the card raises. A kernel has no backward, so one asked for on a CUDA
    tensor that autograd tracks raises: the gradient would stop there."""
    if use_kernels is False:
        return True
    if use_kernels and x.device.type != "cuda":
        raise ValueError(f"use_kernels=True needs CUDA tensors, got "
                         f"{x.device}")
    if x.requires_grad and x.device.type == "cuda":
        raise ValueError("the kernels have no backward: differentiate "
                         "through the plain versions (use_kernels=False)")
    return False


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None, *,
          f32_out: bool = False,
          use_kernels: Optional[bool] = None) -> torch.Tensor:
    """``x @ W (+ b)`` where W is a dense [K, N] tensor, a QuantTensor or
    an Int8Weight (the W8A8 path). The f32 product is cast to x's dtype
    first and the bias added after, in x's dtype, as
    ``bert_tpu.model.dense`` does. ``f32_out`` (no bias)
    hands back the f32 product unrounded, for a consumer that rounds it
    itself: the LayerNorm's f32-input form saves the cast's launch. A
    QuantTensor's or an Int8Weight's product takes the bias and x's dtype
    to its wrapper, whose kernel does the cast and the bias add in its
    epilogue where it can (the same bits, two launches fewer); a bias
    already in x's dtype (the serving model holds it so) is not cast."""
    if f32_out and b is not None:
        raise ValueError("dense: f32_out takes no bias")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    b = None if b is None else b.to(x.dtype)
    out_dtype = torch.float32 if f32_out else x.dtype
    if isinstance(w, (Int8Weight, QuantTensor)):
        plain = _plain(use_kernels, x2)
        if isinstance(w, QuantTensor):
            fn = q4_matmul_plain if plain else q4_matmul
        else:
            fn = int8_matmul_plain if plain else int8_matmul
        return fn(x2, w, b, out_dtype).reshape(*shape[:-1], w.n)
    y = torch.matmul(x2.float(), w.to(x.dtype).float()).to(out_dtype)
    y = y.reshape(*shape[:-1], w.shape[-1])
    return y if b is None else y + b


def dense_codes(x: torch.Tensor, codes: Codes, w: Int8Weight,
                b: Optional[torch.Tensor] = None, *, f32_out: bool = False,
                use_kernels: Optional[bool] = None) -> torch.Tensor:
    """:func:`dense` on an Int8Weight whose input x comes with its codes
    from its producer: the product takes them and launches no
    quantization of x; the same bits."""
    if not isinstance(w, Int8Weight):
        raise ValueError("dense_codes: codes are for an Int8Weight")
    if f32_out and b is not None:
        raise ValueError("dense: f32_out takes no bias")
    y = (int8_matmul_codes_plain if _plain(use_kernels, x)
         else int8_matmul_codes)(*codes, w, None if b is None
                                 else b.to(x.dtype),
                                 torch.float32 if f32_out else x.dtype)
    return y.reshape(*x.shape[:-1], w.n)


def dense_gelu(x: torch.Tensor, w: Int8Weight, b: torch.Tensor,
               codes: Codes, *, approximate: bool,
               use_kernels: Optional[bool] = None) -> torch.Tensor:
    """FFN-up in the int8 regime: ``gelu(x @ W + b)`` in x's dtype from x's
    ``codes``, by the product's form (c); bit for bit :func:`dense`, then
    ``F.gelu``."""
    h = (int8_matmul_gelu_plain if _plain(use_kernels, x)
         else int8_matmul_gelu)(*codes, w, b.to(x.dtype), x.dtype,
                                approximate)
    return h.reshape(*x.shape[:-1], w.n)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float, *, residual: Optional[torch.Tensor] = None,
               pre_bias: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None, codes: bool = False,
               use_kernels: Optional[bool] = None
               ) -> Union[torch.Tensor, Folded]:
    """``LN(x [+ pre_bias] [+ residual])`` in ``out_dtype`` (x's dtype by
    default): the fused kernel, or ``layer_norm_plain`` on x rounded to
    ``out_dtype`` — what the kernel's wrapper runs on a CPU tensor. With
    ``codes``, its codes form: a :class:`Folded`."""
    if _plain(use_kernels, x):
        x = x.to(x.dtype if out_dtype is None else out_dtype)
        if codes:
            return Folded(*layer_norm_codes_plain(x, scale, bias, eps,
                                                  residual, pre_bias))
        return layer_norm_plain(x, scale, bias, eps, residual, pre_bias)
    if codes:
        return Folded(*fused_layer_norm_codes(
            x, scale, bias, eps=eps, residual=residual, pre_bias=pre_bias,
            out_dtype=out_dtype))
    return fused_layer_norm(x, scale, bias, eps=eps, residual=residual,
                            pre_bias=pre_bias, out_dtype=out_dtype)


def embed(token_ids: torch.Tensor, w: Callable[[str], torch.Tensor],
          config: BertConfig, dtype: torch.dtype,
          position_ids: Optional[torch.Tensor] = None, *,
          codes: bool = False, use_kernels: Optional[bool] = None
          ) -> Union[torch.Tensor, Folded]:
    """Token + token-type(0) + position embeddings, then LayerNorm
    (bert.cpp:784-814; ``bert_tpu.model.embed``); ``w(key)`` gives the
    embedding weight of that name. ``codes``: the LayerNorm's codes form,
    for an int8 QKV product (a :class:`Folded`)."""
    # the add order word → token_type → position, in the compute dtype
    t = token_ids.shape[-1]
    x = w("word")[token_ids].to(dtype)
    x = x + w("token_type")[0].to(dtype)
    pos = w("position")
    x = x + (pos[:t] if position_ids is None else pos[position_ids]).to(dtype)
    return layer_norm(x, w("ln_scale"), w("ln_bias"), config.layer_norm_eps,
                      codes=codes, use_kernels=use_kernels)


def _row_parallel(h: torch.Tensor, wt, tp_group,
                  use_kernels: Optional[bool],
                  codes: Optional[Codes] = None) -> torch.Tensor:
    """The attention-output or FFN-down product, for a LayerNorm that
    rounds it to h's dtype. Without tensor parallelism: the f32 product,
    which the LayerNorm rounds (bit for bit bert_tpu's cast, then LN,
    without the cast's own launch). With it: each rank's partial product
    rounded to h's dtype, then summed over ``model`` in that dtype, as
    bert_tpu psums its rounded partials (bert_tpu/model.py:150-161)."""
    product = (functools.partial(dense, h, wt) if codes is None
               else functools.partial(dense_codes, h, codes, wt))
    if tp_group is None:
        return product(f32_out=True, use_kernels=use_kernels)
    return reduce_from_model(product(use_kernels=use_kernels), tp_group)


def encoder_layer(x: Union[torch.Tensor, Folded], w: Callable[[str], object],
                  mask_bias: torch.Tensor, config: BertConfig, *,
                  use_kernels: Optional[bool] = None, tp_group=None,
                  fold: bool = False,
                  last: bool = False) -> Union[torch.Tensor, Folded]:
    """One transformer encoder block (bert.cpp:816-903;
    ``bert_tpu.model.encoder_layer``); ``w(key)`` gives the layer's
    weight of that name. Under tensor parallelism (``tp_group``, the
    ``model`` process group; None = none) the weights are this rank's
    Megatron shard and each residual branch ends in one all-reduce.

    ``fold``: the int8 regime (the module docstring). x is then a
    :class:`Folded` whose codes the QKV product takes, and the output
    comes back as one for the next layer's QKV unless this is the
    ``last`` layer. Under TP FFN-down's codes are quantized from the
    rank's column shard of FFN-up's output, as bert_tpu quantizes the
    local activation."""
    x_codes = None
    if fold:
        x, x_codes = x.x, (x.codes, x.sx)
    dh = config.d_head
    b, t, _ = x.shape
    # ONE fused head-interleaved QKV matmul (params.py); under TP a column
    # shard holds whole heads
    x_in = copy_to_model(x, tp_group)
    qkv = (dense_codes(x_in, x_codes, w("qkv_w"), w("qkv_b"),
                       use_kernels=use_kernels) if fold else
           dense(x_in, w("qkv_w"), w("qkv_b"), use_kernels=use_kernels))
    n_head = qkv.shape[-1] // (3 * dh)
    scale = 1.0 / (dh ** 0.5)  # bert.cpp:848
    # bert_tpu/model.py:135-148. use_kernels=False takes the plain
    # per-(b, h) version at every T, as use_pallas=False takes _mha_jnp.
    # Otherwise two departures: the per-(b, h) kernel runs at every T
    # (bert_tpu takes _mha_jnp below T = 256) and for packed rows'
    # pairwise bias (bert_tpu takes _mha_jnp), since the kernels' route
    # on the card has no plain path
    plain = _plain(use_kernels, qkv)
    if not plain and fused_route(dh):
        ctx = fused_qkv_attention(qkv, mask_bias, n_head=n_head,
                                  d_head=dh, scale=scale)
    else:
        q5 = qkv.view(b, t, n_head, 3, dh).permute(0, 2, 3, 1, 4)
        q, k, v = (q5[:, :, i].contiguous() for i in range(3))
        ctx = (_mha_plain(q, k, v, mask_bias, scale) if plain
               else multi_head_attention(q, k, v, mask_bias, scale=scale))
        ctx = ctx.permute(0, 2, 1, 3).reshape(b, t, n_head * dh)
    att_out = _row_parallel(ctx, w("o_w"), tp_group, use_kernels)
    x = layer_norm(att_out, w("ln_att_scale"), w("ln_att_bias"),
                   config.layer_norm_eps, residual=x, pre_bias=w("o_b"),
                   out_dtype=x.dtype, codes=fold,
                   use_kernels=use_kernels)  # residual 1, bert.cpp:859-875
    if fold:
        x, ln_codes = x.x, (x.codes, x.sx)
        h = dense_gelu(copy_to_model(x, tp_group), w("ff_i_w"), w("ff_i_b"),
                       ln_codes, approximate=config.gelu_approx,
                       use_kernels=use_kernels)
        h2 = h.reshape(-1, h.shape[-1])
        h_codes = (quantize_activations_i8_plain if _plain(use_kernels, h2)
                   else quantize_activations_i8)(h2)
    else:
        h = dense(copy_to_model(x, tp_group), w("ff_i_w"), w("ff_i_b"),
                  use_kernels=use_kernels)
        h = F.gelu(h, approximate="tanh" if config.gelu_approx else "none")
        h_codes = None
    ff_out = _row_parallel(h, w("ff_o_w"), tp_group, use_kernels, h_codes)
    return layer_norm(ff_out, w("ln_out_scale"), w("ln_out_bias"),
                      config.layer_norm_eps, residual=x, pre_bias=w("ff_o_b"),
                      out_dtype=x.dtype, codes=fold and not last,
                      use_kernels=use_kernels)  # residual 2, :885-901


def _run_layers(layers, x: Union[torch.Tensor, Folded],
                mask_bias: torch.Tensor, use_kernels: Optional[bool],
                remat: bool, fold: bool = False) -> torch.Tensor:
    """``x = layer(x, mask_bias, use_kernels)`` for each layer in turn.
    ``remat`` runs each under ``torch.utils.checkpoint`` (non-reentrant):
    the backward recomputes the layer's activations instead of keeping
    them, as bert_tpu's ``jax.checkpoint`` on the scanned layer does.
    ``fold``: the int8 regime, x a :class:`Folded` (:func:`encoder_layer`)."""
    for i, layer in enumerate(layers):
        if fold:
            layer = functools.partial(layer, fold=True,
                                      last=i == len(layers) - 1)
        if remat:
            # the layers draw no random numbers (no dropout, as in
            # bert_tpu), so no generator state is kept for the recompute:
            # reading it inside a CUDA graph capture would be refused
            x = checkpoint(layer, x, mask_bias, use_kernels,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = layer(x, mask_bias, use_kernels)
    return x


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
    (:func:`embed`) over its own weights."""

    def __init__(self, emb: Dict[str, torch.Tensor], config: BertConfig):
        super().__init__()
        self.config = config
        self._register(emb)

    def forward(self, token_ids: torch.Tensor, dtype: torch.dtype,
                position_ids: Optional[torch.Tensor] = None,
                use_kernels: Optional[bool] = None,
                codes: bool = False) -> Union[torch.Tensor, Folded]:
        return embed(token_ids, self.w, self.config, dtype, position_ids,
                     codes=codes, use_kernels=use_kernels)


class EncoderLayer(_Weights):
    """One transformer encoder block over its own weights
    (:func:`encoder_layer`)."""

    def __init__(self, lp: Dict[str, object], config: BertConfig,
                 tp_group=None):
        super().__init__()
        self.config = config
        self.tp_group = tp_group
        self._register(lp)

    def forward(self, x: Union[torch.Tensor, Folded],
                mask_bias: torch.Tensor,
                use_kernels: Optional[bool] = None, *, fold: bool = False,
                last: bool = False) -> Union[torch.Tensor, Folded]:
        return encoder_layer(x, self.w, mask_bias, self.config,
                             use_kernels=use_kernels,
                             tp_group=self.tp_group, fold=fold, last=last)


def layer_slice(v, i: int):
    """Layer ``i``'s weight of a layer-stacked dense tensor, QuantTensor
    or Int8Weight: views, no copy."""
    if isinstance(v, QuantTensor):
        return QuantTensor(packed=v.packed[i], scales=v.scales[i],
                           mins=None if v.mins is None else v.mins[i])
    if isinstance(v, Int8Weight):
        return Int8Weight(w_nk=v.w_nk[i], scale=v.scale[i], k=v.k)
    return v[i]


class _BertHidden:
    """:meth:`hidden` of a BERT encoder, whose position table takes the
    rows' positions (``embed``)."""

    def hidden(self, token_ids: torch.Tensor, mask_bias: torch.Tensor,
               position_ids: Optional[torch.Tensor] = None, *,
               dtype: torch.dtype, use_kernels: Optional[bool] = None,
               remat: bool = False) -> torch.Tensor:
        """token_ids [B, T] at ``position_ids`` [B, T] (None: 0..T-1)
        under the additive ``mask_bias`` → the last layer's output
        [B, T, D]: what :func:`bert_forward` pools, the one call it makes
        of every encoder class."""
        x = self.embed(token_ids, dtype, position_ids, use_kernels=use_kernels)
        return self.encode(x, mask_bias, use_kernels=use_kernels, remat=remat)


class BertModel(_BertHidden, nn.Module):
    """The encoder, built from a layer-stacked device params tree
    (:func:`bert_tpu_torch.params.params_to_torch`). Layer l's weights are
    views ``[l]`` of the stacked tensors, so building it copies nothing:
    two models built from trees that share tensors (the engine's Q4 and
    int8 trees share everything but the matmul weights) share their
    device memory. Built from one rank's tensor-parallel shard, it takes
    the mesh's ``model`` process group as ``tp_group``. A tree of
    Int8Weights (``params_to_int8`` converts every matmul weight at once)
    runs the int8 regime folded (``fold``; the module docstring)."""

    def __init__(self, params: Dict[str, Dict[str, object]],
                 config: BertConfig, tp_group=None):
        super().__init__()
        self.config = config
        self.embeddings = Embeddings(params["embeddings"], config)
        layers = params["layers"]
        self.fold = isinstance(layers["qkv_w"], Int8Weight)
        self.layers = nn.ModuleList(
            EncoderLayer({k: layer_slice(v, i) for k, v in layers.items()},
                         config, tp_group)
            for i in range(config.n_layer))

    def embed(self, token_ids: torch.Tensor, dtype: torch.dtype,
              position_ids: Optional[torch.Tensor] = None, *,
              use_kernels: Optional[bool] = None
              ) -> Union[torch.Tensor, Folded]:
        """The embeddings (a :class:`Folded` under ``fold``)."""
        return self.embeddings(token_ids, dtype, position_ids, use_kernels,
                               codes=self.fold)

    def encode(self, x: Union[torch.Tensor, Folded], mask_bias: torch.Tensor,
               *, use_kernels: Optional[bool] = None,
               remat: bool = False) -> torch.Tensor:
        return _run_layers(self.layers, x, mask_bias, use_kernels, remat,
                           self.fold)


class TrainableBertModel(_BertHidden, nn.Module):
    """The encoder with every weight an ``nn.Parameter`` that an optimizer
    can own, built from a dense layer-stacked device params tree
    (:func:`bert_tpu_torch.params.params_to_torch`, f32 for the repo's
    dense files). The layer weights stay stacked ``[L, ...]``, as in
    bert_tpu's tree, so gradients and optimizer moments have its layout;
    layer l indexes ``[l]`` inside the forward, so every forward builds
    its own autograd graph. The Parameters are copies of the tree's
    tensors, so training leaves the tree (and any array it shares memory
    with) as it was.
    :meth:`tree` hands them back as ``{"embeddings": {...}, "layers":
    {...}}``. Same ``embed`` / ``encode`` / ``hidden`` interface as
    :class:`BertModel`, so :func:`bert_forward` runs either. Built from
    one rank's shard on a mesh (train.make_sharded_train_step), it runs
    tensor-parallel over the mesh's ``model`` process group,
    ``tp_group``."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]],
                 config: BertConfig, tp_group=None):
        super().__init__()
        if isinstance(config, ModernBertConfig):
            raise NotImplementedError(
                "training runs BERT encoders only; ModernBERT (modernbert.py)"
                " is served, not fine-tuned, by this package")
        self.config = config
        self.tp_group = tp_group
        for group in ("embeddings", "layers"):
            for k, v in params[group].items():
                if not isinstance(v, torch.Tensor):
                    raise ValueError(f"{k}: quantized weights do not train; "
                                     "fine-tune the dense model, then "
                                     "quantize")
            setattr(self, group, nn.ParameterDict(
                {k: nn.Parameter(v.detach().clone())
                 for k, v in params[group].items()}))

    def tree(self) -> Dict[str, Dict[str, nn.Parameter]]:
        return {"embeddings": dict(self.embeddings.items()),
                "layers": dict(self.layers.items())}

    def embed(self, token_ids: torch.Tensor, dtype: torch.dtype,
              position_ids: Optional[torch.Tensor] = None, *,
              use_kernels: Optional[bool] = None) -> torch.Tensor:
        return embed(token_ids, self.embeddings.__getitem__, self.config,
                     dtype, position_ids, use_kernels=use_kernels)

    def _layer(self, i: int, x: torch.Tensor, mask_bias: torch.Tensor,
               use_kernels: Optional[bool]) -> torch.Tensor:
        return encoder_layer(x, lambda k: self.layers[k][i], mask_bias,
                             self.config, use_kernels=use_kernels,
                             tp_group=self.tp_group)

    def encode(self, x: torch.Tensor, mask_bias: torch.Tensor, *,
               use_kernels: Optional[bool] = None,
               remat: bool = False) -> torch.Tensor:
        layers = [functools.partial(self._layer, i)
                  for i in range(self.config.n_layer)]
        return _run_layers(layers, x, mask_bias, use_kernels, remat)


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
    # clamp(sq, 1e-24) is clamp(norm, 1e-12) for every value, and keeps a
    # fully padded row's zero vector out of sqrt, whose gradient at 0 is
    # 0/0: the row's gradient is 0, not NaN (bert_tpu's is NaN there)
    sq = torch.sum(torch.square(pooled), dim=-1, keepdim=True)
    return pooled / torch.sqrt(torch.clamp(sq, min=1e-24))


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


def last_pool_l2(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Last-token pool + L2 normalize, in f32: each row's last real token
    under ``mask`` [B, T] (rows are right-padded), as sentence-transformers'
    ``pooling_mode_lasttoken`` pools a decoder's states."""
    last = torch.clamp(mask.sum(dim=-1).long() - 1, min=0)
    rows = torch.arange(x.shape[0], device=x.device)
    return _l2(x[rows, last].float())


POOLINGS = ("mean", "cls", "last")


def _check_pooling(pooling: str, packed: bool = False) -> None:
    if pooling not in POOLINGS:
        raise ValueError(f"pooling must be one of {POOLINGS}, got "
                         f"{pooling!r}")
    if packed and pooling == "last":
        raise ValueError("last-token pooling takes bucketed rows: a causal "
                         "model has no packed form")


def bert_forward(model, token_ids: torch.Tensor, mask: torch.Tensor, *,
                 compute_dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None, remat: bool = False,
                 pooling: str = "mean") -> torch.Tensor:
    """token_ids [B, T] int, mask [B, T] → L2-normalized embeddings
    [B, n_embd] f32 (``bert_tpu.model.bert_forward``), through any encoder
    class's ``hidden``: :class:`BertModel`, :class:`TrainableBertModel`,
    ``modernbert.ModernBertModel`` or ``deepseek_v2.DeepseekV2Model``;
    ``pooling`` "mean", "cls" or "last" (the last real token)."""
    _check_pooling(pooling)
    # 0 for real tokens, NEG_INF for padding
    mask_bias = (mask.float() - 1.0) * (-NEG_INF)
    x = model.hidden(token_ids, mask_bias, dtype=compute_dtype,
                     use_kernels=use_kernels, remat=remat)
    if pooling == "cls":
        return cls_pool_l2(x)
    if pooling == "last":
        return last_pool_l2(x, mask)
    return mean_pool_l2(x, mask)


def bert_forward_packed(model, token_ids: torch.Tensor,
                        segment_ids: torch.Tensor,
                        position_ids: torch.Tensor, *, n_segments: int,
                        compute_dtype: torch.dtype = torch.float32,
                        use_kernels: Optional[bool] = None,
                        remat: bool = False,
                        pooling: str = "mean") -> torch.Tensor:
    """Packed-row forward: token_ids/segment_ids/position_ids [B, T] →
    per-segment L2-normalized embeddings [B, n_segments, n_embd] f32
    (``bert_tpu.model.bert_forward_packed``): per-segment positions,
    block-diagonal attention, per-segment pooling, through any encoder
    class's ``hidden``, as :func:`bert_forward`."""
    _check_pooling(pooling, packed=True)
    x = model.hidden(token_ids, segment_attention_bias(segment_ids),
                     position_ids, dtype=compute_dtype,
                     use_kernels=use_kernels, remat=remat)
    if pooling == "cls":
        return segment_cls_pool_l2(x, segment_ids, n_segments)
    return segment_mean_pool_l2(x, segment_ids, n_segments)

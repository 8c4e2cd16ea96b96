"""Model parameters: HF-named tensors → layer-stacked parameter trees.

Counterpart of ``bert_tpu/params.py``. The host-side tree is the JAX
package's, built with the same numpy calls in the same order so fixtures
come out bit-identical: a plain nested dict whose matmul weights are
``W[in, out]`` arrays or :class:`~bert_tpu_torch.quant.QuantTensor` leaves,
with every layer's instance of a weight stacked along a leading axis.
:func:`params_to_torch` moves that tree onto a device as torch tensors — the
state :class:`bert_tpu_torch.model.BertModel` is built from — and
:func:`params_from_jax` carries a JAX package tree across unchanged,
:func:`train_state_from_jax` a JAX train state (params, AdamW moments,
count and step), and :func:`params_to_numpy` takes a trainable model's
parameters back to a host tree.
"""

from __future__ import annotations

import functools as _functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .ops.int8_matmul import Int8Tensor, quantize_w8, to_device
from .quant import QuantTensor, dequantize_tpu

ArrayLike = Any
WeightLike = Union[ArrayLike, QuantTensor]


@dataclass(frozen=True)
class BertConfig:
    """Static hyperparameters (mirrors bert_hparams, bert.cpp:18-27)."""

    n_vocab: int
    n_max_tokens: int
    n_embd: int
    n_intermediate: int
    n_head: int
    n_layer: int
    ftype: int = 0
    # exact erf GELU matches HF/sentence-transformers; the reference's ggml
    # uses the tanh approximation — selectable for apples-to-apples tests.
    gelu_approx: bool = False
    layer_norm_eps: float = 1e-12

    @property
    def d_head(self) -> int:
        return self.n_embd // self.n_head  # bert.cpp:762

    @classmethod
    def from_hparams(cls, hp) -> "BertConfig":
        return cls(
            n_vocab=hp.n_vocab,
            n_max_tokens=hp.n_max_tokens,
            n_embd=hp.n_embd,
            n_intermediate=hp.n_intermediate,
            n_head=hp.n_head,
            n_layer=hp.n_layer,
            ftype=hp.ftype,
        )


@dataclass(frozen=True)
class ModernBertConfig(BertConfig):
    """A ModernBERT encoder (answerdotai/ModernBERT-base's architecture;
    ``bert_tpu_torch/modernbert.py``): pre-LN blocks, GeGLU of width
    ``n_intermediate``, RoPE, and every ``global_attn_every``-th layer
    (0, every, 2·every, ...) attending over all keys with θ
    ``rope_theta_global``, the others over the keys within
    ``local_window // 2`` positions either side, inclusive, with θ
    ``rope_theta_local``. ``layer_norm_eps`` is its ``norm_eps``."""

    arch: str = "modernbert"
    global_attn_every: int = 3
    local_window: int = 128
    rope_theta_global: float = 160000.0
    rope_theta_local: float = 10000.0

    def is_global(self, layer: int) -> bool:
        return layer % self.global_attn_every == 0

    def window(self, layer: int) -> int:
        """Layer ``layer``'s band half-width: 0 = every key."""
        return 0 if self.is_global(layer) else self.local_window // 2

    def rope_theta(self, layer: int) -> float:
        return (self.rope_theta_global if self.is_global(layer)
                else self.rope_theta_local)


@dataclass(frozen=True)
class DeepseekV2Config(BertConfig):
    """A DeepSeek-V2 decoder used as an embedding backbone
    (``bert_tpu_torch/deepseek_v2.py``): pre-RMSNorm blocks of latent
    attention (MLA, expanded per head for prefill, causal) and, after the
    first ``first_k_dense`` dense SwiGLU layers of width
    ``n_intermediate``, mixture-of-experts layers: ``n_experts`` routed
    experts of width ``moe_intermediate`` of which each token takes
    ``top_k`` by softmax score (greedy, not renormalised) plus
    ``n_shared_experts`` shared ones. ``layer_norm_eps`` is its
    ``rms_norm_eps``. RoPE is YaRN-scaled where ``rope_factor`` > 1."""

    arch: str = "deepseek_v2"
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    kv_lora_rank: int = 512
    first_k_dense: int = 1
    n_experts: int = 64
    top_k: int = 6
    n_shared_experts: int = 2
    moe_intermediate: int = 1408
    routed_scaling: float = 1.0
    rope_theta: float = 10000.0
    rope_factor: float = 1.0
    rope_original_positions: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def n_moe_layers(self) -> int:
        return self.n_layer - self.first_k_dense

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense

    @property
    def softmax_scale(self) -> float:
        """qk_head_dim^-½, times m² where YaRN sets ``mscale_all_dim``
        (the published ``modeling_deepseek.py``)."""
        s = self.qk_head_dim ** -0.5
        if self.rope_factor > 1 and self.rope_mscale_all_dim:
            m = yarn_mscale(self.rope_factor, self.rope_mscale_all_dim)
            s *= m * m
        return s


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's magnitude factor: 0.1 · mscale · ln(factor) + 1 (1 at factor
    ≤ 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def config_class(meta: Dict[str, Any]):
    """The config class of a saved config's fields."""
    return {"modernbert": ModernBertConfig,
            "deepseek_v2": DeepseekV2Config}.get(meta.get("arch"),
                                                 BertConfig)


# The params tree is a plain nested dict:
# {
#   "embeddings": {word [V,D], token_type [2,D], position [P,D],
#                  ln_scale [D], ln_bias [D]},
#   "layers": {qkv_w [L,D,3D] (or QuantTensor with leading L), qkv_b [L,3D],
#              o_w [L,D,D], o_b [L,D],
#              ln_att_scale [L,D], ln_att_bias [L,D],
#              ff_i_w [L,D,F], ff_i_b [L,F], ff_o_w [L,F,D], ff_o_b [L,D],
#              ln_out_scale [L,D], ln_out_bias [L,D]}
# }
#
# QKV fusion: the three projections run as ONE [D, 3D] matmul. Columns are
# HEAD-INTERLEAVED — for head h: [q_h | k_h | v_h], each d_head wide — so the
# attention kernel reads head h's q, k and v in place at lane 3·dh·h
# (ops/fused_attention.py). Q4 quantization blocks run along K, so fusing
# columns is bit-exact vs quantizing q/k/v separately.


def fuse_qkv_weights(wq: np.ndarray, wk: np.ndarray, wv: np.ndarray,
                     n_head: int) -> np.ndarray:
    """Three [K, D] (in, out) weights → one head-interleaved [K, 3D]."""
    k, d = wq.shape
    dh = d // n_head
    stacked = np.stack(
        [wq.reshape(k, n_head, dh), wk.reshape(k, n_head, dh),
         wv.reshape(k, n_head, dh)], axis=2,
    )  # [K, H, 3, dh]
    return np.ascontiguousarray(stacked.reshape(k, 3 * d))


def fuse_qkv_bias(bq: np.ndarray, bk: np.ndarray, bv: np.ndarray,
                  n_head: int) -> np.ndarray:
    d = bq.shape[0]
    dh = d // n_head
    stacked = np.stack(
        [bq.reshape(n_head, dh), bk.reshape(n_head, dh),
         bv.reshape(n_head, dh)], axis=1,
    )  # [H, 3, dh]
    return np.ascontiguousarray(stacked.reshape(3 * d))


# HF tensor-name templates (bert.cpp:536-553, convert-to-ggml.py)
_QKV_SOURCES = {  # fused into qkv_w / qkv_b
    "q": "encoder.layer.{i}.attention.self.query",
    "k": "encoder.layer.{i}.attention.self.key",
    "v": "encoder.layer.{i}.attention.self.value",
}
_LAYER_WEIGHTS = {
    "o_w": "encoder.layer.{i}.attention.output.dense.weight",
    "o_b": "encoder.layer.{i}.attention.output.dense.bias",
    "ln_att_scale": "encoder.layer.{i}.attention.output.LayerNorm.weight",
    "ln_att_bias": "encoder.layer.{i}.attention.output.LayerNorm.bias",
    "ff_i_w": "encoder.layer.{i}.intermediate.dense.weight",
    "ff_i_b": "encoder.layer.{i}.intermediate.dense.bias",
    "ff_o_w": "encoder.layer.{i}.output.dense.weight",
    "ff_o_b": "encoder.layer.{i}.output.dense.bias",
    "ln_out_scale": "encoder.layer.{i}.output.LayerNorm.weight",
    "ln_out_bias": "encoder.layer.{i}.output.LayerNorm.bias",
}
_MATMUL_KEYS = {"qkv_w", "o_w", "ff_i_w", "ff_o_w"}
# the biases model.dense adds to a product in the compute dtype; o_b and
# ff_o_b are the LayerNorms' f32 pre-biases
_PRODUCT_BIASES = {"qkv_b", "ff_i_b"}

_EMB_WEIGHTS = {
    "word": "embeddings.word_embeddings.weight",
    "token_type": "embeddings.token_type_embeddings.weight",
    "position": "embeddings.position_embeddings.weight",
    "ln_scale": "embeddings.LayerNorm.weight",
    "ln_bias": "embeddings.LayerNorm.bias",
}
# embedding tables: cast to the compute dtype where they are used
_EMB_TABLES = ("word", "token_type", "position")


def expected_tensor_names(config: BertConfig) -> list:
    names = list(_EMB_WEIGHTS.values())
    for i in range(config.n_layer):
        for base in _QKV_SOURCES.values():
            names.append(base.format(i=i) + ".weight")
            names.append(base.format(i=i) + ".bias")
        names.extend(t.format(i=i) for t in _LAYER_WEIGHTS.values())
    return names


def params_from_named_tensors(
    named: Dict[str, np.ndarray],
    config: BertConfig,
    quantize_ftype: Optional[int] = None,
    dtype: Any = np.float32,
) -> Dict[str, Dict[str, WeightLike]]:
    """Build the layer-stacked host params tree from HF-named dense f32
    tensors.

    ``named`` holds tensors in HF/torch layout: linear weights are
    ``[out, in]`` and get transposed to ``[in, out]`` here. When
    ``quantize_ftype`` is Q4_0/Q4_1, matmul weights become stacked
    QuantTensors (weight-only quantization; biases & LayerNorms stay f32,
    matching SURVEY.md §2.5).
    """
    from .quant import (
        GGML_FTYPE_Q4_0,
        GGML_FTYPE_Q4_1,
        q4_roundtrip,
        quantize_tensor_tpu,
        stack_quant,
    )

    def get(name: str) -> np.ndarray:
        if name not in named:
            raise KeyError(f"missing tensor {name!r} in checkpoint")
        return np.asarray(named[name], dtype=np.float32)

    quantize = quantize_ftype in (GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1)

    emb = {k: get(v).astype(dtype) for k, v in _EMB_WEIGHTS.items()}
    if quantize:
        # the reference quantizes EVERY 2-D ".*weight" tensor including the
        # embedding tables (SURVEY §2.5); tables stay dense here (gathers),
        # so quantize-on-load must round-trip them through Q4 to match a
        # quantized FILE's densified values
        for k in _EMB_TABLES:
            emb[k] = q4_roundtrip(get(_EMB_WEIGHTS[k]),
                                  quantize_ftype).astype(dtype)
    emb["ln_scale"] = get(_EMB_WEIGHTS["ln_scale"])  # keep f32
    emb["ln_bias"] = get(_EMB_WEIGHTS["ln_bias"])

    def stack_matmul(per_layer):
        """[in, out] weights per layer → stacked dense or QuantTensor."""
        if quantize:
            return stack_quant([quantize_tensor_tpu(w, quantize_ftype)
                                for w in per_layer])
        return np.stack(per_layer).astype(dtype)

    layers: Dict[str, WeightLike] = {}
    qkv_w, qkv_b = [], []
    for i in range(config.n_layer):
        ws = {k: get(v.format(i=i) + ".weight").T  # [out,in] → [in,out]
              for k, v in _QKV_SOURCES.items()}
        bs = {k: get(v.format(i=i) + ".bias") for k, v in _QKV_SOURCES.items()}
        qkv_w.append(fuse_qkv_weights(ws["q"], ws["k"], ws["v"],
                                      config.n_head))
        qkv_b.append(fuse_qkv_bias(bs["q"], bs["k"], bs["v"], config.n_head))
    layers["qkv_w"] = stack_matmul(qkv_w)
    layers["qkv_b"] = np.stack(qkv_b).astype(np.float32)

    for key, tmpl in _LAYER_WEIGHTS.items():
        per_layer = [get(tmpl.format(i=i)) for i in range(config.n_layer)]
        if key in _MATMUL_KEYS:
            layers[key] = stack_matmul([w.T for w in per_layer])
        else:
            layers[key] = np.stack(per_layer).astype(np.float32)

    return {"embeddings": emb, "layers": layers}


def quantize_params(params: Dict[str, Dict[str, WeightLike]],
                    ftype: int) -> Dict[str, Dict[str, WeightLike]]:
    """Quantize a DENSE host params tree's matmul weights to Q4_0/Q4_1
    stacked QuantTensors and round-trip the embedding tables through Q4
    (biases/LayerNorms untouched) — the on-load path for f32/f16 ggml
    files, matching what models/quantize.cpp writes for every 2-D
    ".*weight" tensor (embeddings included)."""
    from .quant import q4_roundtrip, quantize_tensor_tpu, stack_quant

    emb = dict(params["embeddings"])
    for k in _EMB_TABLES:
        v = emb[k]
        if not isinstance(v, QuantTensor):
            emb[k] = q4_roundtrip(np.asarray(v, np.float32), ftype).astype(
                np.asarray(v).dtype)

    layers = dict(params["layers"])
    for key in _MATMUL_KEYS:
        w = layers[key]
        if isinstance(w, QuantTensor):
            continue  # already quantized
        stacked = np.asarray(w, np.float32)
        layers[key] = stack_quant(
            [quantize_tensor_tpu(stacked[l], ftype)
             for l in range(stacked.shape[0])])
    return {"embeddings": emb, "layers": layers}


def params_to_int8(params: Dict[str, Dict[str, WeightLike]]
                   ) -> Dict[str, Dict[str, WeightLike]]:
    """Derive the W8A8 parameter tree (``bert_tpu.params.params_to_int8``):
    every matmul weight becomes a per-column
    :class:`~bert_tpu_torch.ops.int8_matmul.Int8Tensor`. Q4 sources are
    dequantized first; biases, LayerNorms and embedding tables are shared
    with the source tree."""
    layers = dict(params["layers"])
    for key in _MATMUL_KEYS:
        w = layers[key]
        if isinstance(w, QuantTensor):
            n_layer = np.asarray(w.packed).shape[0]
            dense_stack = np.stack([
                dequantize_tpu(QuantTensor(
                    packed=np.asarray(w.packed)[l],
                    scales=np.asarray(w.scales)[l],
                    mins=None if w.mins is None else np.asarray(w.mins)[l],
                )) for l in range(n_layer)
            ])
        else:
            dense_stack = np.asarray(w, np.float32)
        layers[key] = quantize_w8(dense_stack)
    return {"embeddings": params["embeddings"], "layers": layers}


def random_named_tensors(
    config: BertConfig, seed: int = 0, scale: float = 0.02
) -> Dict[str, np.ndarray]:
    """Random HF-layout tensors for fixtures/tests (no network, no HF hub).

    The same draws as ``bert_tpu.params.random_named_tensors``: one
    ``np.random.default_rng(seed)`` stream of float32 normals, in the same
    tensor order. Memoized per (config, seed, scale); the cached arrays are
    read-only so an in-place edit by one caller can't poison another
    (copy before ``torch.from_numpy``); callers get a fresh dict over the
    shared arrays."""
    return dict(_random_named_tensors_cached(config, seed, scale))


@_functools.lru_cache(maxsize=4)
def _random_named_tensors_cached(
    config: BertConfig, seed: int, scale: float
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)

    def t(*shape):
        arr = rng.standard_normal(shape, dtype=np.float32)
        arr *= scale
        return arr

    named: Dict[str, np.ndarray] = {
        "embeddings.word_embeddings.weight": t(config.n_vocab, config.n_embd),
        "embeddings.token_type_embeddings.weight": t(2, config.n_embd),
        "embeddings.position_embeddings.weight": t(
            config.n_max_tokens, config.n_embd
        ),
        "embeddings.LayerNorm.weight": np.ones(config.n_embd, np.float32),
        "embeddings.LayerNorm.bias": np.zeros(config.n_embd, np.float32),
    }
    d, f = config.n_embd, config.n_intermediate
    for i in range(config.n_layer):
        p = f"encoder.layer.{i}."
        named[p + "attention.self.query.weight"] = t(d, d)
        named[p + "attention.self.query.bias"] = t(d)
        named[p + "attention.self.key.weight"] = t(d, d)
        named[p + "attention.self.key.bias"] = t(d)
        named[p + "attention.self.value.weight"] = t(d, d)
        named[p + "attention.self.value.bias"] = t(d)
        named[p + "attention.output.dense.weight"] = t(d, d)
        named[p + "attention.output.dense.bias"] = t(d)
        named[p + "attention.output.LayerNorm.weight"] = np.ones(d, np.float32)
        named[p + "attention.output.LayerNorm.bias"] = np.zeros(d, np.float32)
        named[p + "intermediate.dense.weight"] = t(f, d)
        named[p + "intermediate.dense.bias"] = t(f)
        named[p + "output.dense.weight"] = t(d, f)
        named[p + "output.dense.bias"] = t(d)
        named[p + "output.LayerNorm.weight"] = np.ones(d, np.float32)
        named[p + "output.LayerNorm.bias"] = np.zeros(d, np.float32)
    for arr in named.values():
        arr.flags.writeable = False
    return named


# ---------------------------------------------------------------------------
# device state
# ---------------------------------------------------------------------------

def _to_tensor(a, device, dtype: Optional[torch.dtype] = None
               ) -> torch.Tensor:
    """numpy array → torch tensor on ``device``. Read-only arrays (memoized
    fixtures, mmap views) are copied first: torch.from_numpy shares memory,
    and writing through such a tensor is undefined."""
    a = np.asarray(a)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, copy=True, order="C")
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def params_to_torch(params: Dict[str, Dict[str, WeightLike]], *,
                    device, dtype: torch.dtype = torch.float32
                    ) -> Dict[str, Dict[str, WeightLike]]:
    """Host params tree → the same tree of torch tensors on ``device``.

    ``dtype`` is the storage dtype of the embedding tables and of dense
    matmul weights. The model casts both to its compute dtype where it uses
    them (as the JAX model does), so storing them in the compute dtype
    gives the same numbers in less memory. QuantTensor leaves keep their
    uint8 codes and f32 scales/mins; Int8Tensor leaves become
    :class:`~bert_tpu_torch.ops.int8_matmul.Int8Weight`s (codes transposed
    to the kernel's [N, Kp] layout, f32 scales). The biases that ``dense``
    adds to a product in the compute dtype (QKV's and FFN-up's) are
    stored in ``dtype`` too, so that no call casts them; the LayerNorms'
    pre-biases and parameters stay f32."""
    emb = {}
    for k, v in params["embeddings"].items():
        emb[k] = _to_tensor(v, device,
                            dtype if k in _EMB_TABLES else torch.float32)
    layers: Dict[str, WeightLike] = {}
    for k, v in params["layers"].items():
        if isinstance(v, QuantTensor):
            layers[k] = QuantTensor(
                packed=_to_tensor(v.packed, device, torch.uint8),
                scales=_to_tensor(v.scales, device, torch.float32),
                mins=(None if v.mins is None
                      else _to_tensor(v.mins, device, torch.float32)))
        elif isinstance(v, Int8Tensor):
            layers[k] = to_device(v, device)
        else:
            layers[k] = _to_tensor(
                v, device, dtype if k in _MATMUL_KEYS | _PRODUCT_BIASES
                else torch.float32)
    return {"embeddings": emb, "layers": layers}


def params_from_jax(tree: Dict[str, Dict[str, Any]], config: BertConfig, *,
                    device, dtype: torch.dtype = torch.float32
                    ) -> Dict[str, Dict[str, WeightLike]]:
    """Carry a ``bert_tpu`` params tree across to the port, unchanged.

    ``tree`` is the JAX package's tree as numpy, after
    ``jax.tree_util.tree_map(np.asarray, params)``. Its quantized leaves
    are duck-typed — anything with ``.packed``, ``.scales`` and ``.mins``
    (or None) is Q4, anything with ``.w_i8`` and ``.scale`` is int8 (the
    tree of ``bert_tpu.params.params_to_int8``) — so this module needs
    nothing of the JAX package. Both packages use the same host layouts,
    so the carry is an identity on the arrays. Returns the port's device
    state (:func:`params_to_torch`).
    """
    def leaf(v):
        if hasattr(v, "w_i8") and hasattr(v, "scale"):
            return Int8Tensor(w_i8=np.asarray(v.w_i8),
                              scale=np.asarray(v.scale))
        if hasattr(v, "packed") and hasattr(v, "scales"):
            mins = getattr(v, "mins", None)
            return QuantTensor(packed=np.asarray(v.packed),
                               scales=np.asarray(v.scales),
                               mins=None if mins is None else np.asarray(mins))
        return np.asarray(v)

    host = {part: {k: leaf(v) for k, v in tree[part].items()}
            for part in ("embeddings", "layers")}
    expected = ({"qkv_w", "qkv_b"} | set(_LAYER_WEIGHTS), set(_EMB_WEIGHTS))
    if set(host["layers"]) != expected[0] or set(host["embeddings"]) != \
            expected[1]:
        raise ValueError("params tree does not have the bert_tpu layout: "
                         f"{sorted(host['layers'])}, "
                         f"{sorted(host['embeddings'])}")
    n_layer = host["layers"]["qkv_b"].shape[0]
    if n_layer != config.n_layer:
        raise ValueError(f"tree has {n_layer} layers, config "
                         f"{config.n_layer}")
    return params_to_torch(host, device=device, dtype=dtype)


def _find_adam_state(opt_state):
    """The optax Adam state inside a (nested tuple) optimizer state: the
    one object with ``.mu``, ``.nu`` and ``.count``, found by attribute so
    that nothing of optax is imported."""
    if all(hasattr(opt_state, a) for a in ("mu", "nu", "count")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _find_adam_state(sub)
            if found is not None:
                return found
    return None


def train_state_from_jax(params_tree: Dict[str, Dict[str, Any]], opt_state,
                         step, config: BertConfig, *, optimizer, device):
    """Carry a ``bert_tpu`` TrainState across to the port.

    ``params_tree``, ``opt_state`` and ``step`` are the fields of
    ``bert_tpu.train.TrainState`` as numpy (``jax.tree_util.tree_map(
    np.asarray, ...)`` keeps optax's state objects, whose fields it maps).
    Returns a :class:`bert_tpu_torch.train.TrainState` on ``device`` with
    the same dense parameters, a ``torch.optim.AdamW`` built by
    ``optimizer`` (:func:`bert_tpu_torch.train.make_optimizer`) holding the
    same ``mu``, ``nu`` and ``count``, and the same step."""
    from .model import TrainableBertModel
    from .train import TrainState, init_train_state, place_adam_state

    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (.mu, .nu, .count) in opt_state")
    model = TrainableBertModel(params_from_jax(params_tree, config,
                                               device=device), config)
    state = init_train_state(model, optimizer)
    place_adam_state(state.opt_state, model, adam.mu, adam.nu,
                     int(np.asarray(adam.count)))
    return TrainState(params=model, opt_state=state.opt_state,
                      step=int(np.asarray(step)))


def params_to_numpy(model) -> Dict[str, Dict[str, np.ndarray]]:
    """A :class:`~bert_tpu_torch.model.TrainableBertModel`'s parameters as
    the host params tree (numpy, bert_tpu's layout): what
    :func:`bert_tpu_torch.checkpoint.save_params` writes, and what tests
    hold leaf by leaf against bert_tpu's. A tensor-parallel shard's leaves
    are gathered whole first (a collective over its model group)."""
    from .parallel.sharding import gather_leaf

    return {group: {k: gather_leaf(group, k, p, model.tp_group)
                    .cpu().numpy().copy() for k, p in sub.items()}
            for group, sub in model.tree().items()}

"""DeepSeek-V2 as an embedding backbone on the port's path, at a tiny size
on the CPU with seeded random weights: the port (its plain versions, which
its CUDA kernels are held to on the card by ``chip_smoke.py --deepseek``)
against the plain reference ``tests/plain_deepseek_v2.py``, the reference
against transformers' ``DeepseekV2Model``, YaRN, the rope rows' permutation,
the grouped expert product, the routes, the graph of a MoE batch shape and
the loader's refusals.

The tiny configuration: D 64, 4 heads of q·k 16 + 8 and v 16, latent 64,
8 experts of width 64 (top 2) and 1 shared, 1 dense layer of width 128 and
2 MoE layers, 512 tokens of vocabulary. The latent is 64 and not 32: the
port's Q4 layout packs K in groups of 64 rows (``quant.GROUP``), and the
latent is kv_b's K.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from bert_tpu_torch import BertTorch
from bert_tpu_torch import deepseek_v2 as ds
from bert_tpu_torch.ops import moe as moe_ops
from bert_tpu_torch.ops.mla_attention import yarn_inv_freq
from bert_tpu_torch.quant import (QuantTensor, q4_0_quantize,
                                  q4_to_ggml_bytes, quantize_tensor_tpu)

import plain_deepseek_v2 as plain

TINY = {
    "architectures": ["DeepseekV2ForCausalLM"], "model_type": "deepseek_v2",
    "attention_bias": False, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 128,
    "kv_lora_rank": 64, "max_position_embeddings": 256,
    "moe_intermediate_size": 64, "moe_layer_freq": 1, "n_group": 1,
    "n_routed_experts": 8, "n_shared_experts": 1, "norm_topk_prob": False,
    "num_attention_heads": 4, "num_experts_per_tok": 2,
    "num_hidden_layers": 3, "num_key_value_heads": 4, "q_lora_rank": None,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "rms_norm_eps": 1e-6,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 64,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func":
    "softmax", "seq_aux": True, "tie_word_embeddings": False,
    "topk_group": 1, "topk_method": "greedy", "v_head_dim": 16,
    "vocab_size": 512,
}


def matrix_shapes(cfg):
    """(name, [N, K]) of every matrix; the rest are norms and routers."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    qh = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    out = [("embed_tokens.weight", (cfg["vocab_size"], d))]
    for i in range(cfg["num_hidden_layers"]):
        a = f"layers.{i}.self_attn."
        out += [(a + "q_proj.weight", (h * qh, d)),
                (a + "kv_a_proj_with_mqa.weight",
                 (r + cfg["qk_rope_head_dim"], d)),
                (a + "kv_b_proj.weight", (h * (cfg["qk_nope_head_dim"] + dv),
                                          r)),
                (a + "o_proj.weight", (d, h * dv))]

        def mlp(p, f):
            return [(p + "gate_proj.weight", (f, d)),
                    (p + "up_proj.weight", (f, d)),
                    (p + "down_proj.weight", (d, f))]
        if i < cfg["first_k_dense_replace"]:
            out += mlp(f"layers.{i}.mlp.", cfg["intermediate_size"])
        else:
            f = cfg["moe_intermediate_size"]
            for e in range(cfg["n_routed_experts"]):
                out += mlp(f"layers.{i}.mlp.experts.{e}.", f)
            out += mlp(f"layers.{i}.mlp.shared_experts.",
                       f * cfg["n_shared_experts"])
    return out


def draw(cfg, seed=0, std=0.08, router_std=0.3):
    """name → dense f32 numpy: matrices N(0, std), norms 1 + N(0, 0.1),
    routers N(0, router_std)."""
    rng = np.random.default_rng(seed)
    w = {n: (std * rng.standard_normal(s)).astype(np.float32)
         for n, s in matrix_shapes(cfg)}
    d = cfg["hidden_size"]
    for i in range(cfg["num_hidden_layers"]):
        for n, width in (("input_layernorm", d),
                         ("post_attention_layernorm", d),
                         ("self_attn.kv_a_layernorm", cfg["kv_lora_rank"])):
            w[f"layers.{i}.{n}.weight"] = (
                1 + 0.1 * rng.standard_normal(width)).astype(np.float32)
        if i >= cfg["first_k_dense_replace"]:
            w[f"layers.{i}.mlp.gate.weight"] = (router_std * rng.standard_normal(
                (cfg["n_routed_experts"], d))).astype(np.float32)
    w["norm.weight"] = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return w


def q4_records(w):
    """A dense [N, K] f32 matrix as the checkpoint stores it: Q4_0 blocks
    of 32 along K (``quant.q4_0_quantize``), uint8 [N, K/32, 20]."""
    codes, scales = q4_0_quantize(np.asarray(w, np.float32))
    n, k = w.shape
    return np.frombuffer(q4_to_ggml_bytes(codes, scales), np.uint8).reshape(
        n, k // 32, 20)


def checkpoint_tensors(cfg, dense):
    """The checkpoint's tensors: matrices as Q4_0 records."""
    mats = {n for n, _ in matrix_shapes(cfg)}
    return {("model." + n): (q4_records(v) if n in mats else v)
            for n, v in dense.items()}


def reference_weights(named):
    """The reference's weights: Q4_0 records as (nibbles, scales, shape)."""
    out = {}
    for n, v in named.items():
        if v.dtype == np.uint8:
            nrow, nb, _ = v.shape
            out[n] = (torch.from_numpy(np.ascontiguousarray(v[..., 4:]))
                      .reshape(-1, 16),
                      torch.from_numpy(np.ascontiguousarray(v[..., :4])
                                       .view(np.float32)).reshape(-1),
                      (nrow, nb * 32))
        else:
            out[n] = torch.from_numpy(v)
    return out


def write_safetensors(path, tensors):
    header, offset, blobs = {}, 0, []
    for name, a in tensors.items():
        a = np.ascontiguousarray(a)
        dt = {np.dtype(np.float32): "F32", np.dtype(np.uint8): "U8"}[a.dtype]
        header[name] = {"dtype": dt, "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
        blobs.append(a.tobytes())
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for b in blobs:
            f.write(b)


def write_checkpoint(root, cfg, named, vocab_size=None):
    path = os.path.join(root, "dsv2")
    os.makedirs(os.path.join(path, "1_Pooling"), exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + [
        "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += [f"w{i}" for i in range((vocab_size or cfg["vocab_size"])
                                     - len(vocab))]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(path, "1_Pooling", "config.json"), "w") as f:
        json.dump({"word_embedding_dimension": cfg["hidden_size"],
                   "pooling_mode_lasttoken": True}, f)
    write_safetensors(os.path.join(path, "model.safetensors"), named)
    return path


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    dense = draw(TINY)
    named = checkpoint_tensors(TINY, dense)
    path = write_checkpoint(str(tmp_path_factory.mktemp("dsv2")), TINY,
                            named)
    ref = plain.Reference(reference_weights(named), TINY, "cpu")
    return {"dense": dense, "named": named, "path": path, "ref": ref}


def token_lists(lengths, seed=1):
    rng = np.random.default_rng(seed)
    return [([101] + rng.integers(104, TINY["vocab_size"],
                                  max(n - 2, 0)).tolist() + [102])[:n]
            for n in lengths]


LENGTHS = [1, 2, 5, 17, 40, 63, 64, 65, 96]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_port_against_plain_reference(tiny, dtype):
    """f32: the port's plain path against the reference, both f32 over the
    same Q4_0 codes: only the order of sums differs (the expert combine,
    RMS statistics, rope folded onto de-interleaved lanes), so 1e-4 of a
    unit vector. bf16: the stream, every product's operands and outputs
    are rounded to bf16 (8 bits), about 4e-3 relative a rounding, through
    3 layers and the final norm; 0.05 leaves room for near-tied expert
    choices flipping between the two and stays far below what a wrong
    equation reads (a planted fault, below, reads 0.3 and more)."""
    eng = BertTorch.from_file(tiny["path"], device="cpu",
                              compute_dtype=getattr(
                                  torch, {"f32": "float32",
                                          "bf16": "bfloat16"}[dtype]))
    assert eng.pooling == "last" and not eng._packing
    toks = token_lists(LENGTHS)
    got = eng.eval_tokens(toks)
    want = tiny["ref"].embed(toks).numpy()
    gap = np.linalg.norm(got - want, axis=1).max()
    assert gap < (1e-4 if dtype == "f32" else 0.05), gap
    assert np.allclose(np.linalg.norm(got, axis=1), 1, atol=1e-3)


def test_planted_fault_fails(tiny):
    """The comparison above sees a wrong part: the reference with its RoPE
    left out, or its experts' weights not applied, is far from the port."""
    eng = BertTorch.from_file(tiny["path"], device="cpu")
    toks = token_lists([17, 40, 96])
    got = eng.eval_tokens(toks)

    class NoRope(plain.Reference):
        def rope(self, x, cos, sin):
            return x

    class Unweighted(plain.Reference):
        def route(self, h, router):
            w, idx = super().route(h, router)
            return torch.ones_like(w), idx

    for cls in (NoRope, Unweighted):
        ref = cls(reference_weights(tiny["named"]), TINY, "cpu")
        gap = np.linalg.norm(got - ref.embed(toks).numpy(), axis=1).max()
        assert gap > 0.05, (cls.__name__, gap)


def test_reference_against_transformers(tiny):
    """With ``rope_scaling`` null (where transformers 4.57's native class
    and the published code agree on the softmax scale) the reference's
    hidden states equal transformers' ``DeepseekV2Model``'s, eager, f32,
    on the same dense weights, within f32 rounding."""
    transformers = pytest.importorskip("transformers")
    cfg = dict(TINY, rope_scaling=None)
    hf_cfg = transformers.DeepseekV2Config(**{
        k: v for k, v in cfg.items() if k not in ("architectures",
                                                  "model_type")})
    hf_cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    model = transformers.DeepseekV2Model(hf_cfg).eval()
    dense = tiny["dense"]
    sd = {k: torch.from_numpy(v) for k, v in dense.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all("rotary" in m for m in missing), missing
    ref = plain.Reference({k: torch.from_numpy(v) for k, v in dense.items()},
                          cfg, "cpu")
    for n in (1, 9, 40):
        ids = token_lists([n])[0]
        with torch.no_grad():
            want = model(torch.tensor([ids])).last_hidden_state[0]
        got = ref.hidden_all([ids])[0]
        assert torch.allclose(got, want, atol=2e-5, rtol=2e-5), \
            (got - want).abs().max()


def test_yarn_inv_freq_against_transformers():
    """The port's YaRN inverse frequencies are transformers'
    ``_compute_yarn_parameters``'s at DeepSeek-V2-Lite's settings, and its
    attention factor is 1 there (mscale = mscale_all_dim)."""
    from transformers import DeepseekV2Config
    from transformers.modeling_rope_utils import _compute_yarn_parameters

    rs = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
          "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
          "type": "yarn"}
    cfg = DeepseekV2Config(hidden_size=2048, num_attention_heads=16,
                           qk_rope_head_dim=64, rope_theta=10000,
                           max_position_embeddings=163840, rope_scaling=rs)
    want, factor = _compute_yarn_parameters(cfg, "cpu")
    got = yarn_inv_freq(64, 10000.0, 40.0, 4096, 32.0, 1.0)
    assert factor == 1.0
    assert torch.equal(got, want.float())
    c = ds.config_from_hf(dict(TINY, hidden_size=2048, rope_scaling=rs,
                               qk_nope_head_dim=128, qk_rope_head_dim=64))
    m = 0.1 * 0.707 * np.log(40) + 1
    assert abs(c.softmax_scale - 192 ** -0.5 * m * m) < 1e-12


def test_rope_row_permutation():
    """The de-interleave moves whole output rows: Q4 codes bit for bit, and
    q·k with RoPE over interleaved pairs equals rotate-half over the
    de-interleaved lanes."""
    c = ds.config_from_hf(TINY)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4 * 24, 64)).astype(np.float32)
    rows = ds.q_row_order(c)
    a = ds._repack(q4_records(w), rows)
    b = quantize_tensor_tpu(np.ascontiguousarray(w[rows].T), 2)
    assert np.array_equal(a.packed, b.packed)
    assert np.array_equal(a.scales, b.scales)
    assert sorted(rows.tolist()) == list(range(96))
    # interleaved-pair rotation vs rotate-half on the permuted lanes
    x, y = rng.standard_normal(8), rng.standard_normal(8)
    ang = rng.standard_normal(4)

    def rot_pairs(v):
        z = (v[0::2] + 1j * v[1::2]) * np.exp(1j * ang)
        out = np.empty(8)
        out[0::2], out[1::2] = z.real, z.imag
        return out

    def rot_half(v):
        x1, x2 = v[:4], v[4:]
        return np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                               x2 * np.cos(ang) + x1 * np.sin(ang)])

    perm = ds.rope_row_order(8, 0, 8)
    assert np.isclose(rot_pairs(x) @ rot_pairs(y),
                      rot_half(x[perm]) @ rot_half(y[perm]))


def _routed(m=37, e=6, k=2, seed=5):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(m, e, generator=g)
    logits[:, 3] = -1e4  # expert 3 receives no token
    return logits, moe_ops.moe_route(logits, k, 1.0)


def test_route_sorts_stably():
    """The routing's sorted rows are each expert's tokens in order, the
    slot positions invert the sort, and the counts (expert 3: none) sum to
    M·k."""
    logits, r = _routed()
    assert r.counts[3] == 0 and int(r.counts.sum()) == 37 * 2
    flat = r.topi.reshape(-1).long()
    assert torch.equal(r.sorted_tok[r.slot_pos.long()].long(),
                       torch.arange(74) // 2)
    ends = torch.cumsum(r.counts.long(), 0)
    owner = torch.searchsorted(ends, torch.arange(74), right=True)
    assert torch.equal(owner[r.slot_pos.long()], flat)
    for e in range(6):
        toks = r.sorted_tok[owner == e]
        assert torch.equal(toks, torch.sort(toks).values)
    p = torch.softmax(logits, -1)
    assert torch.allclose(r.topw, torch.topk(p, 2).values)


@pytest.mark.parametrize("swiglu", [True, False])
def test_grouped_product_against_expert_loop(swiglu):
    """The grouped product and the combine against a loop over the experts
    of the tokens routed to each (an expert with none included): the same
    f32 products in the same order, so equal to 1e-6."""
    logits, r = _routed()
    rng = np.random.default_rng(7)
    k, f = 64, 64
    n = 2 * f if swiglu else f
    ws = [rng.standard_normal((n, k)).astype(np.float32) * 0.1
          for _ in range(6)]
    order = moe_ops.swiglu_order(f) if swiglu else np.arange(n)
    qts = [quantize_tensor_tpu(np.ascontiguousarray(w[order].T), 2)
           for w in ws]
    qt = QuantTensor(packed=torch.from_numpy(np.stack([q.packed
                                                       for q in qts])),
                     scales=torch.from_numpy(np.stack([q.scales
                                                       for q in qts])))
    x = torch.from_numpy(rng.standard_normal((37, k)).astype(np.float32))
    y = moe_ops.expert_matmul(x, qt, r, gather=True, swiglu=swiglu)
    from bert_tpu_torch.quant import dequantize_tpu
    dense = [torch.from_numpy(dequantize_tpu(q)) for q in qts]
    want = torch.zeros(74, y.shape[1])
    for e in range(6):
        rows = [i for i in range(74)
                if int(r.topi.reshape(-1)[i]) == e]
        for i in rows:
            v = x[i // 2] @ dense[e]
            if swiglu:
                v4 = v.reshape(-1, 2, 8)
                v = (torch.nn.functional.silu(v4[:, 0]) * v4[:, 1]).reshape(-1)
            want[int(r.slot_pos[i])] = v
    assert torch.allclose(y, want, atol=1e-6)
    shared = torch.randn(37, y.shape[1])
    out = moe_ops.moe_combine(shared, y, r)
    loop = shared.clone()
    for t in range(37):
        for j in range(2):
            loop[t] += r.topw[t, j] * y[int(r.slot_pos[2 * t + j])]
    assert torch.allclose(out, loop, atol=1e-6)


def test_swiglu_order_interleaves_runs():
    order = moe_ops.swiglu_order(16)
    assert order.tolist() == (list(range(0, 8)) + list(range(16, 24))
                              + list(range(8, 16)) + list(range(24, 32)))


def test_packed_route_is_bucketed(tiny):
    """Short texts, which the engine packs for the other models, go to the
    bucketed route here (a causal model has no packed form): the stats
    show bucketed shapes only, and each text embeds as it does alone."""
    eng = BertTorch.from_file(tiny["path"], device="cpu")
    toks = token_lists([3, 5, 7, 9, 11, 30, 2, 4])
    got = eng.eval_tokens(toks)
    assert all(k != "packed" for _, _, k in eng.timers.bucket_counts)
    alone = np.stack([eng.eval_tokens([t])[0] for t in toks])
    assert np.allclose(got, alone, atol=1e-5)
    st = eng.stats()
    assert set(st["experts"]) == {"1", "2"}
    assert all(k.startswith("causal ") for k in st["attention"])


def test_expert_counts_match_launched_tokens(tiny):
    """``stats()["experts"]`` counts k tokens a launched token (padding
    rows included) in each MoE layer."""
    eng = BertTorch.from_file(tiny["path"], device="cpu")
    eng.eval_tokens(token_lists([5, 17, 40, 63]))
    st = eng.stats()
    launched = sum(b * s * n for (b, s, _), n in
                   eng.timers.bucket_counts.items())
    for layer, counts in st["experts"].items():
        assert sum(counts) == 2 * launched, layer


def test_moe_batch_is_one_graph(tiny, monkeypatch):
    """A MoE batch shape replays as one program (CPU: its function run
    eagerly): the same batch shape twice captures once, and the routing,
    grouped product and combine are reached through it (their plain
    versions on the CPU, counted by the model's expert counter)."""
    eng = BertTorch.from_file(tiny["path"], device="cpu")
    toks = token_lists([17, 20])
    eng.eval_tokens(toks)
    n0 = len(eng._programs.table)
    c0 = eng.model.expert_tokens.clone()
    eng.eval_tokens(token_lists([18, 19], seed=4))
    assert len(eng._programs.table) == n0
    # 2 rows of T 32, 2 choices a token, 2 MoE layers
    assert int((eng.model.expert_tokens - c0).sum()) == 2 * 32 * 2 * 2


@pytest.mark.parametrize("key,value", [
    ("q_lora_rank", 1536), ("topk_method", "group_limited_greedy"),
    ("scoring_func", "sigmoid"), ("norm_topk_prob", True),
    ("hidden_act", "gelu"), ("attention_bias", True),
    ("rope_scaling", {"type": "linear", "factor": 2.0})])
def test_loader_refuses(key, value):
    with pytest.raises(ValueError, match="not supported"):
        ds.config_from_hf(dict(TINY, **{key: value}))


def test_loader_refuses_dense_matrix(tiny, tmp_path):
    """A matrix stored dense (not as Q4_0 records) is refused by name, and
    int8_eval and a mesh are refused at construction."""
    named = dict(tiny["named"])
    named["model.layers.0.self_attn.o_proj.weight"] = \
        tiny["dense"]["layers.0.self_attn.o_proj.weight"]
    path = write_checkpoint(str(tmp_path), TINY, named)
    with pytest.raises(ValueError, match="Q4_0 records"):
        BertTorch.from_file(path, device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        BertTorch.from_file(tiny["path"], device="cpu", int8_eval=True)


def test_use_kernels_false_is_the_default_bit_for_bit(tiny):
    """On the CPU the default engine reaches the plain versions through
    the kernel wrappers, and ``use_kernels=False`` calls them directly:
    the same bits."""
    toks = token_lists([5, 40, 96])
    a = BertTorch.from_file(tiny["path"], device="cpu").eval_tokens(toks)
    b = BertTorch.from_file(tiny["path"], device="cpu",
                            use_kernels=False).eval_tokens(toks)
    np.testing.assert_array_equal(a, b)


def test_yarn_cos_sin_scale_where_mscales_differ(tiny, tmp_path):
    """Where ``mscale`` and ``mscale_all_dim`` differ, the published code
    scales cos and sin by m(factor, mscale) / m(factor, mscale_all_dim);
    the port does too (f32, the same codes as above)."""
    cfg = dict(TINY, rope_scaling=dict(TINY["rope_scaling"], mscale=1.0))
    path = write_checkpoint(str(tmp_path), cfg, tiny["named"])
    ref = plain.Reference(reference_weights(tiny["named"]), cfg, "cpu")
    toks = token_lists([17, 64])
    got = BertTorch.from_file(path, device="cpu").eval_tokens(toks)
    want = ref.embed(toks).numpy()
    assert np.linalg.norm(got - want, axis=1).max() < 1e-4
    base = tiny["ref"].embed(toks).numpy()
    assert np.linalg.norm(want - base, axis=1).max() > 1e-3

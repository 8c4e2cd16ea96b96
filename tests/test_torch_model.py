"""The port's encoder forward on the CPU against bert_tpu's.

At a small config (2 layers, D=128, F=256, H=4) the same weights — the
JAX package's params tree, carried across with params_from_jax — go
through bert_tpu.model (use_pallas=False, the jnp path the JAX model runs
on a CPU) and through bert_tpu_torch.model, bucketed and packed, mean and
CLS pooled. At the full MiniLM-L6 width the port reproduces the committed
golden embeddings within the tolerances of tests/test_goldens.py. A
d_head = 26 config (rubert-tiny2's head dim), a d_head = 80 config and a
d_head = 160 one (D = 1280) take the other attention route, the
per-(batch, head) kernel's, in both packages.

Tolerances: f32 2e-5 (the goldens' f32 bound: same arithmetic, other
summation order); bf16 5e-3 (the goldens' bf16 bound: the frameworks round
bf16 intermediates at different places).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bert_tpu import model as jmodel
from bert_tpu.packing import pack_batch, plan_packing
from bert_tpu.params import BertConfig as JConfig
from bert_tpu.params import params_from_named_tensors as j_params_from_named
from bert_tpu.params import random_named_tensors as j_random_named
from bert_tpu.tokenizer import WordPieceTokenizer as JTokenizer
from bert_tpu_torch import model as tmodel
from bert_tpu_torch.ops.fused_attention import fused_route
from bert_tpu_torch.params import BertConfig as TConfig
from bert_tpu_torch.params import (
    params_from_jax,
    params_from_named_tensors,
    params_to_torch,
    random_named_tensors,
)
from bert_tpu_torch.tokenizer import WordPieceTokenizer
from bert_tpu_torch.vocab import Vocab
from fixture_vocab import build_fixture_tokens, build_fixture_vocab
from make_goldens import CFG_KW, PAD_T, SEED, SENTENCES
from test_goldens import GOLDEN_PATH, TOLS

# One intra-op thread: the suite runs several test files at once, and
# torch's default pool (one thread per core, in every worker) starves
# the timing-sensitive tests running beside these.
torch.set_num_threads(1)

SMALL = dict(n_vocab=512, n_max_tokens=64, n_embd=128, n_intermediate=256,
             n_head=4, n_layer=2)
DTYPES = {"f32": (torch.float32, jnp.float32, 2e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 5e-3)}


@pytest.fixture(scope="module")
def small_models():
    """ftype → (JAX params tree, port BertModel on the same weights)."""
    named = j_random_named(JConfig(**SMALL), seed=11)
    out = {}
    for ftype in (None, 2, 3):
        jtree = j_params_from_named(named, JConfig(**SMALL),
                                    quantize_ftype=ftype)
        host = jax.tree_util.tree_map(np.asarray, jtree)
        state = params_from_jax(host, TConfig(**SMALL), device="cpu")
        out[ftype] = (jtree, tmodel.BertModel(state, TConfig(**SMALL)))
    return out


def _batch(rng, b=5, t=24):
    lens = rng.integers(3, t + 1, size=b)
    lens[0] = t
    ids = np.zeros((b, t), np.int32)
    mask = np.zeros((b, t), np.float32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, SMALL["n_vocab"], size=n)
        mask[i, :n] = 1.0
    return ids, mask


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("ftype", [None, 2, 3], ids=["f32w", "q4_0", "q4_1"])
def test_bert_forward_matches_bert_tpu(small_models, ftype, pooling, dname):
    td, jd, tol = DTYPES[dname]
    jtree, tm = small_models[ftype]
    ids, mask = _batch(np.random.default_rng(1))
    want = jmodel.bert_forward(jtree, jnp.asarray(ids), jnp.asarray(mask),
                               JConfig(**SMALL), compute_dtype=jd,
                               use_pallas=False, pooling=pooling)
    with torch.inference_mode():
        got = tmodel.bert_forward(tm, torch.from_numpy(ids).long(),
                                  torch.from_numpy(mask), compute_dtype=td,
                                  pooling=pooling)
    assert got.dtype == torch.float32 and got.shape == (5, SMALL["n_embd"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("ftype", [None, 2], ids=["f32w", "q4_0"])
def test_bert_forward_packed_matches_bert_tpu(small_models, ftype, pooling):
    jtree, tm = small_models[ftype]
    rng = np.random.default_rng(2)
    lists = [list(rng.integers(1, SMALL["n_vocab"], size=int(n)))
             for n in rng.integers(3, 20, size=9)]
    plan = plan_packing([len(t) for t in lists], 32, 4)
    ids, seg, pos, flat = pack_batch(lists, plan, n_rows=plan.n_rows + 1)
    want = jmodel.bert_forward_packed(
        jtree, jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos),
        JConfig(**SMALL), n_segments=4, use_pallas=False, pooling=pooling)
    with torch.inference_mode():
        got = tmodel.bert_forward_packed(
            tm, torch.from_numpy(ids).long(), torch.from_numpy(seg),
            torch.from_numpy(pos).long(), n_segments=4, pooling=pooling)
    assert got.shape == (plan.n_rows + 1, 4, SMALL["n_embd"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # packed == solo: the placed sentences equal their bucketed forward
    solo_ids = np.zeros((len(lists), 20), np.int64)
    solo_mask = np.zeros((len(lists), 20), np.float32)
    for i, t in enumerate(lists):
        solo_ids[i, :len(t)] = t
        solo_mask[i, :len(t)] = 1.0
    with torch.inference_mode():
        solo = tmodel.bert_forward(tm, torch.from_numpy(solo_ids),
                                   torch.from_numpy(solo_mask),
                                   pooling=pooling)
    rows = got.reshape(-1, SMALL["n_embd"])[torch.from_numpy(flat).long()]
    order = [p.index for p in plan.placements]
    np.testing.assert_allclose(rows.numpy(), solo.numpy()[order], atol=2e-5)


def test_segment_attention_bias_matches_bert_tpu():
    seg = np.array([[1, 1, 2, 2, 2, 0], [1, 2, 3, 0, 0, 0]], np.int32)
    got = tmodel.segment_attention_bias(torch.from_numpy(seg))
    want = jmodel.segment_attention_bias(jnp.asarray(seg))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def golden_port():
    """The port's own pipeline, end to end: its random_named_tensors,
    params_from_named_tensors and forward, at the goldens' MiniLM-L6
    width."""
    cfg = TConfig(**CFG_KW)
    named = random_named_tensors(cfg, seed=SEED)
    with np.load(GOLDEN_PATH) as z:
        ids = z["token_ids"]
        golden = {k: z[k] for k in ("f32", "q4_0", "q4_1", "bf16")}
    return cfg, named, ids, golden


@pytest.mark.parametrize("variant", ["f32", "q4_0", "q4_1", "bf16"])
def test_goldens_full_width(golden_port, variant):
    cfg, named, ids, golden = golden_port
    ftype, dtype = {"f32": (None, torch.float32), "q4_0": (2, torch.float32),
                    "q4_1": (3, torch.float32),
                    "bf16": (None, torch.bfloat16)}[variant]
    model = tmodel.BertModel(params_to_torch(
        params_from_named_tensors(named, cfg, quantize_ftype=ftype),
        device="cpu"), cfg)
    ids_t = torch.from_numpy(ids).long()
    with torch.inference_mode():
        emb = tmodel.bert_forward(model, ids_t, (ids_t != 0).float(),
                                  compute_dtype=dtype)
    np.testing.assert_allclose(emb.numpy(), golden[variant],
                               atol=TOLS[variant])


def test_golden_token_ids_from_port_tokenizer(golden_port):
    """The goldens' token ids come out of the port's tokenizer too."""
    _, _, ids, _ = golden_port
    tok = WordPieceTokenizer(Vocab.from_tokens(build_fixture_tokens()))
    jtok = JTokenizer(build_fixture_vocab())
    for row, s in zip(ids, SENTENCES):
        t = tok.tokenize(s, CFG_KW["n_max_tokens"])
        assert t == jtok.tokenize(s, CFG_KW["n_max_tokens"])
        assert len(t) <= PAD_T and list(row[:len(t)]) == t
        assert not row[len(t):].any()


# d_head = 52 / 2 = 26, 160 / 2 = 80 and 1280 / 8 = 160: no fused-kernel
# instance, so both packages take the per-(batch, head) route (bert_tpu:
# multi_head_attention on the CPU); 80 is what the kernel's DH = 128
# instance takes on the card, 160 its instance for head dims above 128, and
# D = 1280 the LayerNorm's block-per-row instance
DH26 = dict(n_vocab=512, n_max_tokens=256, n_embd=52, n_intermediate=96,
            n_head=2, n_layer=2)
DH80 = dict(n_vocab=512, n_max_tokens=256, n_embd=160, n_intermediate=192,
            n_head=2, n_layer=2)
DH160 = dict(n_vocab=512, n_max_tokens=256, n_embd=1280, n_intermediate=256,
             n_head=8, n_layer=2)
MHA_CONFIGS = {"dh26": DH26, "dh80": DH80, "dh160": DH160}


@pytest.fixture(scope="module")
def mha_models():
    """config name → (JAX params tree, port BertModel on the same
    weights), each built on first use."""
    built = {}

    def get(name):
        if name not in built:
            cfg = MHA_CONFIGS[name]
            named = j_random_named(JConfig(**cfg), seed=12)
            jtree = j_params_from_named(named, JConfig(**cfg))
            host = jax.tree_util.tree_map(np.asarray, jtree)
            state = params_from_jax(host, TConfig(**cfg), device="cpu")
            built[name] = (jtree, tmodel.BertModel(state, TConfig(**cfg)))
        return built[name]
    return get


@pytest.mark.parametrize("cfg", list(MHA_CONFIGS))
@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_dh26_bert_forward_matches_bert_tpu(mha_models, pooling, cfg):
    jtree, tm = mha_models(cfg)
    rng = np.random.default_rng(3)
    ids, mask = _batch(rng, b=4, t=80)
    want = jmodel.bert_forward(jtree, jnp.asarray(ids), jnp.asarray(mask),
                               JConfig(**MHA_CONFIGS[cfg]), use_pallas=False,
                               pooling=pooling)
    with torch.inference_mode():
        got = tmodel.bert_forward(tm, torch.from_numpy(ids).long(),
                                  torch.from_numpy(mask), pooling=pooling)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("cfg", list(MHA_CONFIGS))
def test_dh26_bert_forward_packed_matches_bert_tpu(mha_models, cfg):
    jtree, tm = mha_models(cfg)
    rng = np.random.default_rng(4)
    lists = [list(rng.integers(1, MHA_CONFIGS[cfg]["n_vocab"], size=int(n)))
             for n in rng.integers(3, 30, size=7)]
    plan = plan_packing([len(t) for t in lists], 64, 4)
    ids, seg, pos, _ = pack_batch(lists, plan, n_rows=plan.n_rows + 1)
    want = jmodel.bert_forward_packed(
        jtree, jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos),
        JConfig(**MHA_CONFIGS[cfg]), n_segments=4, use_pallas=False)
    with torch.inference_mode():
        got = tmodel.bert_forward_packed(
            tm, torch.from_numpy(ids).long(), torch.from_numpy(seg),
            torch.from_numpy(pos).long(), n_segments=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("d_head,fused", [(26, False), (32, True),
                                          (64, True), (128, False),
                                          (160, False)])
def test_fused_route(d_head, fused):
    for t, pairwise in ((64, True), (512, False), (2048, False)):
        assert fused_route(t, 12, d_head, torch.bfloat16,
                           pairwise=pairwise) is fused


@pytest.mark.parametrize("cfg,route", [(DH26, "mha"), (SMALL, "fused"),
                                       (DH80, "mha"), (DH160, "mha")],
                         ids=["dh26", "dh32", "dh80", "dh160"])
def test_encoder_layer_takes_its_route(monkeypatch, cfg, route):
    """A spy on both attention entry points: d_head 26, 80 and 160 go to
    multi_head_attention on [B, H, T, dh] operands, d_head 32 to the fused
    QKV kernel on the [B, T, 3D] projection."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, tuple(args[0].shape)))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tmodel, "multi_head_attention",
                        spy("mha", tmodel.multi_head_attention))
    monkeypatch.setattr(tmodel, "fused_qkv_attention",
                        spy("fused", tmodel.fused_qkv_attention))
    c = TConfig(**cfg)
    model = tmodel.BertModel(params_to_torch(params_from_named_tensors(
        random_named_tensors(c, 1), c), device="cpu"), c)
    ids = torch.ones((2, 16), dtype=torch.long)
    with torch.inference_mode():
        tmodel.bert_forward(model, ids, torch.ones((2, 16)))
    want = ((2, c.n_head, 16, c.d_head) if route == "mha"
            else (2, 16, 3 * c.n_embd))
    assert calls == [(route, want)] * c.n_layer


@pytest.mark.parametrize("ftype", [None, 2], ids=["f32w", "q4_0"])
def test_encoder_layer_hands_the_layer_norm_the_f32_product(monkeypatch,
                                                            ftype):
    """On a bf16 model both post-projection LayerNorms get the f32 product
    of o_w and ff_o_w with a bf16 out_dtype (the kernel's f32-input form,
    one launch fewer each), and the layer's output is exactly that of
    casting the product to bf16 first and normalising the bf16 tensor."""
    c = TConfig(**SMALL)
    model = tmodel.BertModel(params_to_torch(params_from_named_tensors(
        random_named_tensors(c, 2), c, quantize_ftype=ftype),
        device="cpu"), c)
    layer = model.layers[0]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 16, c.n_embd)).astype(
        np.float32)).to(torch.bfloat16)
    mask_bias = torch.zeros(2, 16)
    calls = []
    real_ln, real_dense = tmodel.fused_layer_norm, tmodel.dense

    def spy(x, *args, **kw):
        calls.append((x.dtype, kw.get("out_dtype"), kw["residual"].dtype
                      if kw.get("residual") is not None else None))
        return real_ln(x, *args, **kw)

    monkeypatch.setattr(tmodel, "fused_layer_norm", spy)
    with torch.inference_mode():
        got = layer(x, mask_bias)
    bf16 = torch.bfloat16
    assert calls == [(torch.float32, bf16, bf16)] * 2
    assert got.dtype == bf16

    # the parent's layer: every product cast to x's dtype, LN on bf16
    def cast_then_ln(x, *args, out_dtype=None, **kw):
        return real_ln(x.to(out_dtype or x.dtype), *args, **kw)

    monkeypatch.setattr(tmodel, "fused_layer_norm", cast_then_ln)
    monkeypatch.setattr(tmodel, "dense",
                        lambda x, w, b=None, f32_out=False, use_kernels=None:
                        real_dense(x, w, b, use_kernels=use_kernels))
    with torch.inference_mode():
        want = layer(x, mask_bias)
    assert torch.equal(got, want)

"""The port's W8A8 int8 regime on the CPU against bert_tpu's.

Op level, bit for bit on the same numpy inputs: the weight codecs, the
per-row activation quantization (f32 and bf16, a zero row, rows of ties
at x·inv = k + 0.5), the int8 matmul (its plain version multiplies the
codes in f64, exact for every K the repo meets) and ``params_to_int8``
from dense, Q4_0 and Q4_1 trees. Model and engine level, within 1e-5 in
f32: the same arithmetic in another summation order, which can move a
code by one where x·inv lies within an ulp of a rounding boundary. The
engine's routing is tests/test_int8.py's, on the port.

The fixture shapes are tests/test_int8.py's (D 64, F 128, 4 heads, 2
layers); the matmuls also run at a MiniLM QKV width (37×384×1152), at
bert-base's FFN-down width (16×3072×768) and at a ragged K (37×33×200);
the epilogue's two forms (the f32 product; the product rounded to the
compute dtype plus a bias) at M 1 and 37, K 33 and 312, N 8 and 200, and
``dense`` on an Int8Weight, bit for bit its former cast and add.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bert_tpu import model as jmodel
from bert_tpu.engine import BertTPU
from bert_tpu.loader import LoadedModel as JLoaded
from bert_tpu.ops import int8_matmul as J
from bert_tpu.packing import pack_batch, plan_packing
from bert_tpu.params import BertConfig as JConfig
from bert_tpu.params import params_from_named_tensors as j_params_from_named
from bert_tpu.params import params_to_int8 as j_params_to_int8
from bert_tpu.params import random_named_tensors as j_random_named
from bert_tpu_torch import BertTorch
from bert_tpu_torch import model as tmodel
from bert_tpu_torch.loader import LoadedModel
from bert_tpu_torch.ops import int8_matmul as T
from bert_tpu_torch.params import BertConfig, params_from_jax
from bert_tpu_torch.params import params_from_named_tensors
from bert_tpu_torch.params import params_to_int8, params_to_torch
from fixture_vocab import build_fixture_vocab

# One intra-op thread: the suite runs several test files at once, and
# torch's default pool (one thread per core, in every worker) starves
# the timing-sensitive tests running beside these.
torch.set_num_threads(1)

SMALL = dict(n_vocab=512, n_max_tokens=64, n_embd=64, n_intermediate=128,
             n_head=4, n_layer=2)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _activations(rng, m, k):
    """Random rows at spread scales, row 0 all zeros, row 1 with ±amax and
    exact ties (amax 127 → sx 1, x·inv = x), row 2 with ties at sx 1/8."""
    x = (rng.standard_normal((m, k))
         * rng.uniform(0.01, 8.0, (m, 1))).astype(np.float32)
    x[0] = 0.0
    if m > 2 and k >= 4:
        x[1] = rng.choice([0.5, -0.5, 2.5, -3.5, 126.5, -126.5], size=k)
        x[1, :2] = (127.0, -127.0)
        x[2] = rng.choice([0.0625, -0.1875, 1.5625], size=k)
        x[2, 0] = 127.0 / 8
    return x


def _both(x32, dname):
    td, jd = DTYPES[dname]
    return torch.from_numpy(x32).to(td), jnp.asarray(x32, dtype=jd)


# -- codecs ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(128, 96), (3, 64, 32), (2, 33, 200)],
                         ids=["flat", "stacked", "ragged"])
def test_w8_codecs_match_bert_tpu(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w[..., 5] = 0.0  # a zero column: scale 0, codes 0
    got, want = T.quantize_w8(w), J.quantize_w8(w)
    assert got.w_i8.dtype == np.int8 and got.scale.dtype == np.float32
    np.testing.assert_array_equal(got.w_i8, want.w_i8)
    np.testing.assert_array_equal(got.scale, want.scale)
    np.testing.assert_array_equal(T.dequantize_w8(got), J.dequantize_w8(want))


def test_device_layout_pads_k_with_zeros():
    it = T.quantize_w8(np.random.default_rng(1).standard_normal(
        (2, 33, 24)).astype(np.float32))
    w = T.to_device(it, "cpu")
    assert (w.k, w.kp, w.n) == (33, 64, 24)
    assert tuple(w.w_nk.shape) == (2, 24, 64) and w.w_nk.is_contiguous()
    np.testing.assert_array_equal(w.w_nk[..., :33].numpy(),
                                  np.swapaxes(it.w_i8, -1, -2))
    assert not w.w_nk[..., 33:].any()


# -- activation quantization and the matmul ----------------------------------

@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("m, k", [(37, 384), (16, 3072), (5, 33), (3, 1)])
def test_quantize_activations_matches_bert_tpu(m, k, dname):
    xt, xj = _both(_activations(np.random.default_rng(m + k), m, k), dname)
    codes, sx = T.quantize_activations_i8_plain(xt)
    want_codes, want_sx = J.quantize_activations_i8(xj)
    assert codes.dtype == torch.int8 and codes.shape == (m, -(-k // 32) * 32)
    np.testing.assert_array_equal(codes[:, :k].numpy(),
                                  np.asarray(want_codes))
    assert not codes[:, k:].any()  # the zero tail
    np.testing.assert_array_equal(sx.numpy(), np.asarray(want_sx))
    assert not codes[0].any() and sx[0] == 0  # a zero row: no NaN
    assert codes.min() >= -127
    # the wrapper takes the plain version for a CPU tensor
    c2, s2 = T.quantize_activations_i8(xt)
    assert torch.equal(c2, codes) and torch.equal(s2, sx)


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("m, k, n", [(37, 384, 1152), (16, 3072, 768),
                                     (37, 33, 200)])
def test_int8_matmul_matches_bert_tpu(m, k, n, dname):
    rng = np.random.default_rng(k)
    xt, xj = _both(_activations(rng, m, k), dname)
    it = T.quantize_w8((rng.standard_normal((k, n)) * 0.05).astype(
        np.float32))
    want = np.asarray(J.int8_matmul(xj, J.Int8Tensor(it.w_i8, it.scale)))
    w = T.to_device(it, "cpu")
    got = T.int8_matmul_plain(xt, w)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(T.int8_matmul(xt, w), got)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("n", [8, 200])
@pytest.mark.parametrize("k", [33, 312])
@pytest.mark.parametrize("m", [1, 37])
def test_int8_matmul_epilogue_forms(m, k, n, dname, bias):
    """Form (b): the product rounded to ``out_dtype`` and the bias added in
    it, bit for bit the cast and add that follow form (a), and bert_tpu's
    ``int8_matmul(x, it).astype(dt) + b.astype(dt)``."""
    rng = np.random.default_rng(m * k + n)
    td, jd = DTYPES[dname]
    xt, xj = _both(_activations(rng, m, k), dname)
    it = T.quantize_w8((rng.standard_normal((k, n)) * 0.05).astype(
        np.float32))
    b32 = rng.standard_normal(n).astype(np.float32)
    bt, bj = (torch.from_numpy(b32).to(td), jnp.asarray(b32, dtype=jd))
    w = T.to_device(it, "cpu")
    got = T.int8_matmul_plain(xt, w, bias=bt if bias else None,
                              out_dtype=td)
    want = T.int8_matmul_plain(xt, w).to(td)
    jwant = J.int8_matmul(xj, J.Int8Tensor(it.w_i8, it.scale)).astype(jd)
    if bias:
        want, jwant = want + bt, jwant + bj
    assert got.dtype == td and got.shape == (m, n)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jwant.astype(jnp.float32)))
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(T.int8_matmul(xt, w, bt if bias else None, td), got)


@pytest.mark.parametrize("form", ["bias", "nobias", "f32_out"])
@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_dense_int8_keeps_its_bits(form, dname):
    """``dense`` on an Int8Weight hands the cast and the bias to the int8
    product's epilogue: the same bits as the f32 product cast to x's dtype
    with the bias added after (``f32_out``: the f32 product itself)."""
    rng = np.random.default_rng(7)
    td, _ = DTYPES[dname]
    x = torch.from_numpy(_activations(rng, 10, 96)).to(td).reshape(2, 5, 96)
    w = T.to_device(T.quantize_w8(
        (rng.standard_normal((96, 40)) * 0.05).astype(np.float32)), "cpu")
    b = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    prod = T.int8_matmul_plain(x.reshape(-1, 96), w).reshape(2, 5, 40)
    for use_kernels in (None, False):
        if form == "f32_out":
            got = tmodel.dense(x, w, f32_out=True, use_kernels=use_kernels)
            want = prod
        else:
            bias = b if form == "bias" else None
            got = tmodel.dense(x, w, bias, use_kernels=use_kernels)
            want = prod.to(td)
            if bias is not None:
                want = want + b.to(td)
        assert got.dtype == want.dtype and got.shape == (2, 5, 40)
        assert torch.equal(got, want)


def test_int8_wrappers_raise_off_cpu_and_cuda():
    """A tensor neither on the CPU nor on CUDA raises; the wrappers never
    take the plain version there (ops/fused_attention.py's rule)."""
    w = T.to_device(T.quantize_w8(np.ones((64, 8), np.float32)), "cpu")
    x = torch.empty((4, 64), device="meta")
    before = (T.int8_matmul.launches, T.quantize_activations_i8.launches)
    with pytest.raises(ValueError, match="unsupported device meta"):
        T.quantize_activations_i8(x)
    with pytest.raises(ValueError, match="unsupported device meta"):
        T.int8_matmul(x, w)
    with pytest.raises(ValueError, match="unsupported device meta"):
        T.int8_matmul_codes(torch.empty((4, 64), dtype=torch.int8,
                                        device="meta"),
                            torch.empty(4, device="meta"), w)
    assert (T.int8_matmul.launches,
            T.quantize_activations_i8.launches) == before


def test_int8_wrappers_check_their_operands():
    w = T.to_device(T.quantize_w8(np.ones((64, 8), np.float32)), "cpu")
    with pytest.raises(ValueError, match="K=32, the weight K=64"):
        T.int8_matmul(torch.ones((2, 32)), w)
    with pytest.raises(TypeError, match="not in"):
        T.int8_matmul(torch.ones((2, 64), dtype=torch.float16), w)
    # K · 127² must stay under 2^31: the int32 sum of the kernel
    big = T.MAX_K + 1
    assert big * 127 * 127 > 2**31 - 1 >= T.MAX_K * 127 * 127
    with pytest.raises(ValueError, match="overflow"):
        T.quantize_activations_i8(torch.ones((1, big)))
    # the epilogue's operands: out_dtype f32 or bf16; a bias [N] in it, on
    # the product's device, contiguous
    x = torch.ones((2, 64))
    with pytest.raises(TypeError, match="out_dtype torch.float16 not in"):
        T.int8_matmul(x, w, out_dtype=torch.float16)
    for bad in (torch.ones(7), torch.ones((1, 8)), torch.ones(16)[::2],
                torch.ones(8, dtype=torch.bfloat16),
                torch.ones(8, device="meta")):
        with pytest.raises(ValueError, match="bias must be contiguous"):
            T.int8_matmul(x, w, bad)
    with pytest.raises(ValueError, match="bias must be contiguous "
                       "torch.bfloat16"):
        T.int8_matmul(x, w, torch.ones(8), torch.bfloat16)


# -- parameter trees ---------------------------------------------------------

def _leaves(tree):
    out = {}
    for group, sub in tree.items():
        for key, v in sub.items():
            if hasattr(v, "w_i8"):
                out[f"{group}/{key}.w_i8"] = np.asarray(v.w_i8)
                out[f"{group}/{key}.scale"] = np.asarray(v.scale)
            elif hasattr(v, "packed"):
                out[f"{group}/{key}.packed"] = np.asarray(v.packed)
            else:
                out[f"{group}/{key}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("ftype", [None, 2, 3], ids=["dense", "q4_0", "q4_1"])
def test_params_to_int8_matches_bert_tpu(ftype):
    named = j_random_named(JConfig(**SMALL), seed=12)
    got = params_to_int8(params_from_named_tensors(
        named, BertConfig(**SMALL), quantize_ftype=ftype))
    want = jax.tree_util.tree_map(np.asarray, j_params_to_int8(
        j_params_from_named(named, JConfig(**SMALL), quantize_ftype=ftype)))
    a, b = _leaves(got), _leaves(want)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert isinstance(got["layers"]["ff_o_w"], T.Int8Tensor)


@pytest.fixture(scope="module")
def int8_models():
    """ftype → (bert_tpu's int8 tree, the port's model carried across with
    params_from_jax, the port's model from its own params_to_int8)."""
    named = j_random_named(JConfig(**SMALL), seed=12)
    out = {}
    for ftype in (None, 2):
        jtree = j_params_to_int8(j_params_from_named(
            named, JConfig(**SMALL), quantize_ftype=ftype))
        host = jax.tree_util.tree_map(np.asarray, jtree)
        carried = tmodel.BertModel(
            params_from_jax(host, BertConfig(**SMALL), device="cpu"),
            BertConfig(**SMALL))
        own = tmodel.BertModel(params_to_torch(params_to_int8(
            params_from_named_tensors(named, BertConfig(**SMALL),
                                      quantize_ftype=ftype)), device="cpu"),
            BertConfig(**SMALL))
        out[ftype] = (jtree, carried, own)
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


@pytest.mark.parametrize("which", ["carried", "own"])
@pytest.mark.parametrize("ftype", [None, 2], ids=["dense", "q4_0"])
def test_int8_forward_matches_bert_tpu(int8_models, ftype, which):
    jtree, carried, own = int8_models[ftype]
    tm = carried if which == "carried" else own
    assert any(isinstance(tm.layers[0].w(k), T.Int8Weight)
               for k in ("qkv_w", "ff_o_w"))
    ids, mask = _batch(np.random.default_rng(1))
    want = jmodel.bert_forward(jtree, jnp.asarray(ids), jnp.asarray(mask),
                               JConfig(**SMALL))
    with torch.inference_mode():
        got = tmodel.bert_forward(tm, torch.from_numpy(ids).long(),
                                  torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("ftype", [None, 2], ids=["dense", "q4_0"])
def test_int8_packed_forward_matches_bert_tpu(int8_models, ftype):
    jtree, carried, _ = int8_models[ftype]
    rng = np.random.default_rng(2)
    lists = [list(rng.integers(1, SMALL["n_vocab"], size=int(n)))
             for n in rng.integers(3, 20, size=9)]
    plan = plan_packing([len(t) for t in lists], 32, 4)
    ids, seg, pos, _ = pack_batch(lists, plan, n_rows=plan.n_rows)
    want = jmodel.bert_forward_packed(
        jtree, jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos),
        JConfig(**SMALL), n_segments=4)
    with torch.inference_mode():
        got = tmodel.bert_forward_packed(
            carried, torch.from_numpy(ids).long(), torch.from_numpy(seg),
            torch.from_numpy(pos).long(), n_segments=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# -- the engine --------------------------------------------------------------

TEXTS = ["hello world", "the quick brown fox", "I'm going to the store",
         "a b c d", "store store", "going going going", "don't",
         "one two three"]


@pytest.fixture(scope="module")
def engine_fixture():
    vocab = build_fixture_vocab()
    kw = dict(SMALL, n_vocab=len(vocab))
    named = j_random_named(JConfig(**kw), seed=13)
    return vocab, kw, named


def _engines(engine_fixture, **kw):
    vocab, cfg_kw, named = engine_fixture
    jl = JLoaded(config=JConfig(**cfg_kw), vocab=vocab,
                 params=j_params_from_named(named, JConfig(**cfg_kw)))
    tl = LoadedModel(config=BertConfig(**cfg_kw), vocab=vocab,
                     params=params_from_named_tensors(named,
                                                      BertConfig(**cfg_kw)))
    return (BertTPU(jl, max_batch=8, wire_dtype="f32", **kw),
            BertTorch(tl, device="cpu", max_batch=8, wire_dtype="f32", **kw))


def test_engine_int8_matches_bert_tpu(engine_fixture):
    """int8 everywhere (threshold 0), as benchmarks/eval_common.py runs it:
    packed rows and buckets both take the int8 tree in both packages."""
    jeng, teng = _engines(engine_fixture, int8_eval=True, int8_threshold=0)
    texts = TEXTS + [" ".join(["store going"] * 20)]  # a bucketed one
    np.testing.assert_allclose(teng.encode_batch(texts),
                               jeng.encode_batch(texts), atol=1e-5)
    assert teng._model_for(0) is teng.model_int8
    layer_i8, layer = teng.model_int8.layers[0], teng.model.layers[0]
    # the int8 model shares everything but the matmul weights
    assert layer_i8.qkv_b.data_ptr() == layer.qkv_b.data_ptr()
    assert (teng.model_int8.embeddings.word.data_ptr()
            == teng.model.embeddings.word.data_ptr())


def test_engine_threshold_routing(engine_fixture):
    """tests/test_int8.py::test_engine_threshold_routing on the port."""
    _, eng_i8 = _engines(engine_fixture, int8_eval=True, int8_threshold=1)
    _, eng_f = _engines(engine_fixture, int8_eval=False)
    assert eng_i8.model_int8 is not None and eng_f.model_int8 is None
    a = eng_i8.encode_batch(TEXTS)
    b = eng_f.encode_batch(TEXTS)
    cos = (a * b).sum(-1)
    assert cos.min() > 0.999, cos
    assert not np.array_equal(a, b)  # the int8 tree really ran
    _, eng_hi = _engines(engine_fixture, int8_eval=True,
                         int8_threshold=1 << 30)
    assert eng_hi._model_for(64 * 128) is eng_hi.model
    np.testing.assert_allclose(eng_hi.encode_batch(TEXTS), b, atol=1e-6)


def test_model_for_counts_padded_tokens(engine_fixture):
    _, eng = _engines(engine_fixture, int8_eval=True)  # threshold 8,192
    assert eng._model_for(64 * 128) is eng.model_int8
    assert eng._model_for(64 * 128 - 1) is eng.model
    # warmup's shapes take both regimes: 1×16 on Q4/dense, 8×64 on int8
    _, eng = _engines(engine_fixture, int8_eval=True, int8_threshold=512)
    eng.warmup(batch_sizes=[1, 8], max_rows=8)
    assert {(1, 16, "bucketed"), (8, 64, "packed")} <= {
        (r, s, k) for r, s, k in eng._load_manifest_shapes(
            [{"rows": 1, "seq": 16}, {"rows": 8, "seq": 64,
                                      "kind": "packed"}])}

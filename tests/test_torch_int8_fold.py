"""The int8 regime's quantization folded into its producers, on the CPU.

The port's W8A8 path no longer quantizes the QKV and FFN-up inputs on
their own: the LayerNorm's codes form writes the codes of its rounded
output, and int8_matmul's form (c) applies GELU after form (b), whose
output the single-pass codes kernel quantizes for FFN-down. Here the plain versions
of each (what the wrappers run on a CPU tensor) are held to bert_tpu's
ops and to the unfolded composition they replace, bit for bit where the
arithmetic is the same and within a stated bound where bert_tpu's GELU
rounds otherwise; and the folded model to the unfolded forward, bit for
bit. The kernels themselves run only on the card (chip_smoke.py holds
them to these plain versions there).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from bert_tpu.ops import int8_matmul as J
from bert_tpu_torch import _kernels
from bert_tpu_torch import model as tmodel
from bert_tpu_torch.ops import int8_matmul as T
from bert_tpu_torch.ops import layer_norm as L
from bert_tpu_torch.ops.attention import _mha_plain
from bert_tpu_torch.ops.common import NEG_INF
from bert_tpu_torch.params import BertConfig, params_from_named_tensors
from bert_tpu_torch.params import params_to_int8, params_to_torch
from bert_tpu.params import BertConfig as JConfig
from bert_tpu.params import random_named_tensors as j_random_named
from test_torch_int8 import DTYPES, SMALL, _activations, _both

torch.set_num_threads(1)


# -- the codes pass on FFN-down's input ----------------------------------------

@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("m, k", [(37, 384), (16, 3072), (5, 33), (3, 1)])
def test_quantize_gelu_output_matches_bert_tpu(m, k, dname):
    """FFN-down's codes: the quantization of GELU's output (rows skewed
    to the positive side, many values near zero, gelu(0) = 0 for the zero
    row), through the wrapper and the plain version, is bert_tpu's
    ``quantize_activations_i8`` of the same values, bit for bit."""
    x32 = _activations(np.random.default_rng(3 * m + k), m, k)
    td, jd = DTYPES[dname]
    h = F.gelu(torch.from_numpy(x32).to(td))
    codes, sx = T.quantize_activations_i8(h)  # the wrapper, on the CPU
    want_codes, want_sx = J.quantize_activations_i8(
        jnp.asarray(h.float().numpy(), dtype=jd))
    np.testing.assert_array_equal(codes[:, :k].numpy(),
                                  np.asarray(want_codes))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(want_sx))
    assert not codes[:, k:].any() and not codes[0].any() and sx[0] == 0
    c2, s2 = T.quantize_activations_i8_plain(h)
    assert torch.equal(c2, codes) and torch.equal(s2, sx)


# -- the LayerNorm's codes form ----------------------------------------------

LN_FORMS = [("bf16", "plain"), ("bf16", "res_pb"), ("bf16", "f32_in"),
            ("f32", "plain"), ("f32", "res_pb")]


@pytest.mark.parametrize("d", [64, 312, 768])
@pytest.mark.parametrize("dname, form", LN_FORMS)
def test_layer_norm_codes_form(dname, form, d):
    """The codes form's plain version: its output is today's LayerNorm's,
    bit for bit, and its codes and sx are bert_tpu's
    ``quantize_activations_i8`` of that rounded output, bit for bit; in
    bf16 and f32, with and without residual and pre_bias, and the
    f32-input form (an f32 product rounded to bf16 first)."""
    rng = np.random.default_rng(d + len(form))
    td = DTYPES[dname][0]
    m = 29
    x32 = (rng.standard_normal((2, m, d)) * 3.0).astype(np.float32)
    x = torch.from_numpy(x32)
    x = x if form == "f32_in" else x.to(td)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    kw = {}
    if form != "plain":
        kw = dict(residual=torch.from_numpy(rng.standard_normal(
            (2, m, d)).astype(np.float32)).to(td),
            pre_bias=torch.from_numpy(rng.standard_normal(d).astype(
                np.float32)))
    out, codes, sx = L.fused_layer_norm_codes(x, scale, bias, eps=1e-12,
                                              out_dtype=td, **kw)
    want = L.fused_layer_norm(x, scale, bias, eps=1e-12, out_dtype=td, **kw)
    assert out.dtype == td and torch.equal(out, want)
    assert codes.shape == (2 * m, -(-d // 32) * 32) and sx.shape == (2 * m,)
    jcodes, jsx = J.quantize_activations_i8(
        jnp.asarray(out.float().numpy().reshape(-1, d),
                    dtype=DTYPES[dname][1]))
    np.testing.assert_array_equal(codes[:, :d].numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    assert not codes[:, d:].any()
    # and the model's entry, through the plain versions as well
    for use_kernels in (None, False):
        got = tmodel.layer_norm(x, scale, bias, 1e-12, out_dtype=td,
                                codes=True, use_kernels=use_kernels, **kw)
        assert isinstance(got, tmodel.Folded)
        assert all(torch.equal(a, b) for a, b in zip(got, (out, codes, sx)))


# -- form (c): bias and GELU --------------------------------------------------

def _np(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("m, k, n", [(37, 64, 128), (5, 33, 200)])
def test_int8_matmul_gelu_form(m, k, n, dname, approximate):
    """Form (c)'s plain version is ``F.gelu`` of form (b), bit for bit.
    Against bert_tpu's
    ``jax.nn.gelu(int8_matmul(x, w).astype(dt) + b)``: f32 within 1e-6 ·
    (1 + |ref|) (torch's 1 + erf and JAX's erfc round differently; the
    repo's tolerance rule). bf16: within one ulp (+ 1e-6 where torch's 1 +
    erf cancels) of bert_tpu's GELU of the same bf16 values taken in f32
    and rounded once, as F.gelu rounds: 111, 70, 39 and 2 values (0.2-3.9%)
    of the four cases sit one ulp off, none further. bert_tpu's all-bf16
    ``jax.nn.gelu`` rounds each of its ops and differs at 32-42% of the
    values, by at most 0.0156 (checked within 0.05): the port's GELU is
    ``F.gelu``'s arithmetic, and form (c) keeps its bits."""
    rng = np.random.default_rng(m + k + n + approximate)
    td, jd = DTYPES[dname]
    xt, xj = _both(_activations(rng, m, k), dname)
    it = T.quantize_w8((rng.standard_normal((k, n)) * 0.05).astype(
        np.float32))
    w = T.to_device(it, "cpu")
    b32 = rng.standard_normal(n).astype(np.float32)
    bt, bj = torch.from_numpy(b32).to(td), jnp.asarray(b32, dtype=jd)
    codes, sx = T.quantize_activations_i8_plain(xt)
    h = T.int8_matmul_gelu_plain(codes, sx, w, bt, td, approximate)
    form_b = T.int8_matmul_codes_plain(codes, sx, w, bt, td)
    want = F.gelu(form_b, approximate="tanh" if approximate else "none")
    assert h.dtype == td and h.shape == (m, n) and torch.equal(h, want)
    assert torch.equal(T.int8_matmul_gelu(codes, sx, w, bt, td, approximate),
                       h)
    y = J.int8_matmul(xj, J.Int8Tensor(it.w_i8, it.scale)).astype(jd) + bj
    if dname == "f32":
        ref = _np(jax.nn.gelu(y, approximate=approximate))
        assert bool(((h - ref).abs() <= 1e-6 * (1 + ref.abs())).all())
        return
    # bf16: bert_tpu's GELU of the same bf16 values, in f32, rounded once
    ref = _np(jax.nn.gelu(y.astype(jnp.float32), approximate=approximate)
              ).to(torch.bfloat16).float()
    hf = h.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs())) - 7)
    assert bool(((hf - ref).abs() <= ulp + 1e-6).all())
    off = int((hf != ref).sum())
    assert off <= 0.05 * h.numel(), off
    # bert_tpu's own bf16 jax.nn.gelu rounds each of its ops to bf16
    jb = _np(jax.nn.gelu(y, approximate=approximate))
    assert float((hf - jb).abs().max()) <= 0.05


# -- the folded model --------------------------------------------------------

def _unfolded_forward(model, ids, mask, config, dtype):
    """The int8 forward as the port ran it before the fold, on the plain
    versions: each LayerNorm alone, then the product quantizes its input
    (``int8_matmul_plain``); FFN-up in form (b), then ``F.gelu``, then
    FFN-down quantizes it with its own reduction."""
    x = tmodel.embed(ids, model.embeddings.w, config, dtype,
                     use_kernels=False)
    mask_bias = (mask.float() - 1.0) * (-NEG_INF)
    dh = config.d_head
    eps = config.layer_norm_eps
    for layer in model.layers:
        w = layer.w
        b, t, _ = x.shape
        qkv = tmodel.dense(x, w("qkv_w"), w("qkv_b"), use_kernels=False)
        h5 = qkv.view(b, t, -1, 3, dh).permute(0, 2, 3, 1, 4)
        q, k, v = (h5[:, :, i].contiguous() for i in range(3))
        ctx = _mha_plain(q, k, v, mask_bias, 1.0 / dh ** 0.5)
        ctx = ctx.permute(0, 2, 1, 3).reshape(b, t, -1)
        att = tmodel.dense(ctx, w("o_w"), f32_out=True, use_kernels=False)
        x = tmodel.layer_norm(att, w("ln_att_scale"), w("ln_att_bias"), eps,
                              residual=x, pre_bias=w("o_b"),
                              out_dtype=x.dtype, use_kernels=False)
        h = tmodel.dense(x, w("ff_i_w"), w("ff_i_b"), use_kernels=False)
        h = F.gelu(h, approximate="tanh" if config.gelu_approx else "none")
        ff = tmodel.dense(h, w("ff_o_w"), f32_out=True, use_kernels=False)
        x = tmodel.layer_norm(ff, w("ln_out_scale"), w("ln_out_bias"), eps,
                              residual=x, pre_bias=w("ff_o_b"),
                              out_dtype=x.dtype, use_kernels=False)
    return tmodel.mean_pool_l2(x, mask)


@pytest.fixture(scope="module")
def int8_trees():
    named = j_random_named(JConfig(**SMALL), seed=12)
    return {ftype: params_to_torch(params_to_int8(params_from_named_tensors(
        named, BertConfig(**SMALL), quantize_ftype=ftype)), device="cpu")
        for ftype in (None, 2)}


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("ftype", [None, 2], ids=["dense", "q4_0"])
def test_folded_int8_forward_equals_unfolded(int8_trees, ftype, dname,
                                             approximate):
    """The folded int8 forward (codes from the LayerNorms, FFN-up's form
    (c)) equals the unfolded one bit for bit, through the wrappers and
    through the plain versions; only the last layer hands back no codes."""
    config = BertConfig(**SMALL, gelu_approx=approximate)
    model = tmodel.BertModel(int8_trees[ftype], config)
    assert model.fold
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(1, SMALL["n_vocab"], (3, 20))).long()
    mask = torch.ones((3, 20))
    mask[1, 12:] = 0.0
    mask[2, 5:] = 0.0
    td = DTYPES[dname][0]
    with torch.inference_mode():
        want = _unfolded_forward(model, ids, mask, config, td)
        for use_kernels in (None, False):
            x = model.embed(ids, td, use_kernels=use_kernels)
            assert isinstance(x, tmodel.Folded)
            mb = (mask - 1.0) * (-NEG_INF)
            y = model.layers[0](x, mb, use_kernels, fold=True)
            assert isinstance(y, tmodel.Folded)
            assert isinstance(model.layers[1](y, mb, use_kernels, fold=True,
                                              last=True), torch.Tensor)
            got = tmodel.bert_forward(model, ids, mask, compute_dtype=td,
                                      use_kernels=use_kernels)
            assert torch.equal(got, want), float((got - want).abs().max())


def test_dense_trees_do_not_fold():
    """A dense or Q4 tree keeps the unfolded path: no codes anywhere."""
    named = j_random_named(JConfig(**SMALL), seed=12)
    model = tmodel.BertModel(params_to_torch(params_from_named_tensors(
        named, BertConfig(**SMALL), quantize_ftype=2), device="cpu"),
        BertConfig(**SMALL))
    assert not model.fold
    ids = torch.ones((1, 8), dtype=torch.long)
    assert isinstance(model.embed(ids, torch.float32), torch.Tensor)


# -- bindings and operand checks ---------------------------------------------

_CTYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float}


@pytest.mark.parametrize("name, fn", [
    ("int8_matmul", "quantize_rows_i8_f32"),
    ("int8_matmul", "quantize_rows_i8_bf16"),
    ("int8_matmul", "int8_matmul_gelu"),
    ("layer_norm", "layer_norm_codes_f32"),
    ("layer_norm", "layer_norm_codes_bf16"),
    ("layer_norm", "layer_norm_codes_f32_bf16")])
def test_new_entry_signatures_match_their_sources(name, fn):
    """Each new entry's ctypes argtypes follow its C parameters one by one
    (a pointer, an int or a float at each place): the library is bound
    only on the card, where a slip passes garbage."""
    with open(os.path.join(_kernels.SRC_DIR, name + ".cu")) as f:
        src = f.read()
    params = re.search(r'extern "C" int ' + fn + r'\(([^)]*)\)',
                       src).group(1).split(",")
    kinds = [re.sub(r"\s+", " ", p.replace("const ", "")).strip()
             .rsplit(" ", 1)[0].replace(" *", "*") for p in params]
    assert [_CTYPES[k] for k in kinds] == _kernels.SIGNATURES[name][fn]


def test_new_wrappers_raise_off_cpu_and_cuda():
    """The new entries raise for a tensor neither on the CPU nor on CUDA,
    before any launch is counted; none takes the plain version there."""
    w = T.to_device(T.quantize_w8(np.ones((64, 8), np.float32)), "cpu")
    before = (T.int8_matmul_gelu.launches,
              L.fused_layer_norm_codes.launches,
              T.quantize_activations_i8.launches)
    meta = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        T.int8_matmul_gelu(torch.empty((4, 64), dtype=torch.int8,
                                       device="meta"),
                           torch.empty(4, device="meta"), w)
    with pytest.raises(ValueError, match="unsupported device meta"):
        L.fused_layer_norm_codes(meta, torch.ones(64, device="meta"),
                                 torch.zeros(64, device="meta"), eps=1e-12)
    with pytest.raises(ValueError, match="unsupported device meta"):
        T.quantize_activations_i8(meta)
    assert (T.int8_matmul_gelu.launches, L.fused_layer_norm_codes.launches,
            T.quantize_activations_i8.launches) == before


def test_new_wrappers_check_their_operands():
    w = T.to_device(T.quantize_w8(np.ones((64, 8), np.float32)), "cpu")
    x = torch.ones((2, 64))
    codes, sx = T.quantize_activations_i8(x)
    with pytest.raises(ValueError, match="codes must be contiguous"):
        T.int8_matmul_gelu(codes[:, :32], sx, w)
    with pytest.raises(ValueError, match="sx must be contiguous"):
        T.int8_matmul_gelu(codes, sx[:1], w)
    with pytest.raises(ValueError, match="bias must be contiguous"):
        T.int8_matmul_gelu(codes, sx, w, torch.ones(7))
    with pytest.raises(TypeError, match="out_dtype torch.float16 not in"):
        T.int8_matmul_gelu(codes, sx, w, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="codes are for an Int8Weight"):
        tmodel.dense_codes(x, (codes, sx), torch.ones((64, 8)))

"""bert_tpu_torch's host side against bert_tpu's, bit for bit.

The port keeps its own copy of every numpy module it needs (importing any
bert_tpu module imports JAX), so these tests pin each copy to the original:
the Q4_0/Q4_1 codecs, the ggml block bytes, the group-local layout, the
stream repack (native and numpy), the dequantization (numpy and torch), the
ggml writer and loader, and the weight carrier params_from_jax. Every
comparison here is exact: both sides run the same numpy (or, for the torch
dequant, the same single-rounding f32 ops)."""

import numpy as np
import pytest
import torch

import jax

from bert_tpu import quant as jq
from bert_tpu.formats import GgmlHParams as JHParams
from bert_tpu.formats import write_ggml as j_write_ggml
from bert_tpu.loader import load_ggml_model as j_load_ggml_model
from bert_tpu.params import BertConfig as JConfig
from bert_tpu.params import params_from_named_tensors as j_params_from_named
from bert_tpu.params import random_named_tensors as j_random_named
from bert_tpu_torch import native as tnative
from bert_tpu_torch import quant as tq
from bert_tpu_torch.formats import GgmlHParams as THParams
from bert_tpu_torch.formats import read_ggml as t_read_ggml
from bert_tpu_torch.formats import write_ggml as t_write_ggml
from bert_tpu_torch.loader import load_ggml_model as t_load_ggml_model
from bert_tpu_torch.ops.q4_matmul import q4_dequantize
from bert_tpu_torch.params import BertConfig as TConfig
from bert_tpu_torch.params import params_from_jax, params_to_torch
from bert_tpu_torch.params import params_from_named_tensors as t_params_from_named
from bert_tpu_torch.params import random_named_tensors as t_random_named
from fixture_vocab import build_fixture_tokens

# One intra-op thread: the suite runs several test files at once, and
# torch's default pool (one thread per core, in every worker) starves
# the timing-sensitive tests running beside these.
torch.set_num_threads(1)

FTYPES = [tq.GGML_FTYPE_Q4_0, tq.GGML_FTYPE_Q4_1]
SMALL = dict(n_vocab=30522, n_max_tokens=64, n_embd=64, n_intermediate=128,
             n_head=2, n_layer=2)


def _weights(seed, shape=(96, 256)):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    # exact .5 ties after scaling: the roundf-vs-rint trap the codecs pin
    w[0, :32] = np.arange(32, dtype=np.float32) - 15.5
    w[1, :32] = 0.0  # an all-zero block (d = 0)
    return w


def _assert_qt_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.packed), np.asarray(b.packed))
    np.testing.assert_array_equal(np.asarray(a.scales), np.asarray(b.scales))
    assert (a.mins is None) == (b.mins is None)
    if a.mins is not None:
        np.testing.assert_array_equal(np.asarray(a.mins), np.asarray(b.mins))


@pytest.mark.parametrize("ftype", FTYPES)
def test_codecs_bit_identical(ftype):
    w = _weights(1)
    if ftype == tq.GGML_FTYPE_Q4_0:
        t_out, j_out = tq.q4_0_quantize(w), jq.q4_0_quantize(w)
        deq = (tq.q4_0_dequantize(*t_out), jq.q4_0_dequantize(*j_out))
    else:
        t_out, j_out = tq.q4_1_quantize(w), jq.q4_1_quantize(w)
        deq = (tq.q4_1_dequantize(*t_out), jq.q4_1_dequantize(*j_out))
    for a, b in zip(t_out, j_out):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(*deq)
    np.testing.assert_array_equal(tq.q4_roundtrip(w, ftype),
                                  jq.q4_roundtrip(w, ftype))


@pytest.mark.parametrize("ftype", FTYPES)
def test_ggml_block_bytes_bit_identical(ftype):
    w = _weights(2)
    parts = (tq.q4_0_quantize(w) if ftype == tq.GGML_FTYPE_Q4_0
             else tq.q4_1_quantize(w))
    codes, scales = parts[0], parts[1]
    mins = parts[2] if len(parts) == 3 else None
    raw = tq.q4_to_ggml_bytes(codes, scales, mins)
    assert raw == jq.q4_to_ggml_bytes(codes, scales, mins)
    for a, b in zip(tq.q4_from_ggml_bytes(raw, w.shape, ftype),
                    jq.q4_from_ggml_bytes(raw, w.shape, ftype)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    assert tq.ggml_nbytes(w.shape, ftype) == jq.ggml_nbytes(w.shape, ftype)


@pytest.mark.parametrize("ftype", FTYPES)
def test_group_local_layout_bit_identical(ftype):
    w_kn = _weights(3, (256, 96))
    t_qt = tq.quantize_tensor_tpu(w_kn, ftype)
    _assert_qt_equal(t_qt, jq.quantize_tensor_tpu(w_kn, ftype))
    codes = tq.unpack_tpu_layout(t_qt.packed)
    np.testing.assert_array_equal(codes, jq.unpack_tpu_layout(t_qt.packed))
    np.testing.assert_array_equal(tq.pack_tpu_layout(codes),
                                  jq.pack_tpu_layout(codes))
    np.testing.assert_array_equal(tq.pack_tpu_layout(codes), t_qt.packed)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("ftype", FTYPES)
def test_stream_repack_bit_identical(ftype, native, monkeypatch):
    """repack_ggml_stream_tpu through csrc/q4repack.cpp and through numpy
    equals bert_tpu's (which takes its own native path when built)."""
    w_nk = _weights(4, (96, 256))  # stored [N, K]
    parts = (tq.q4_0_quantize(w_nk) if ftype == tq.GGML_FTYPE_Q4_0
             else tq.q4_1_quantize(w_nk))
    raw = tq.q4_to_ggml_bytes(*parts[:2], parts[2] if len(parts) == 3
                              else None)
    if native:
        assert tnative.native_q4_repack(
            np.frombuffer(raw, np.uint8), 96, 256,
            4 if ftype == tq.GGML_FTYPE_Q4_0 else 8) is not None
    else:
        monkeypatch.setattr(tnative, "native_q4_repack",
                            lambda *a, **k: None)
    got = tq.repack_ggml_stream_tpu(raw, (96, 256), ftype)
    _assert_qt_equal(got, jq.repack_ggml_stream_tpu(raw, (96, 256), ftype))
    # and it is the transpose of the stored tensor's codes, repacked
    codes, scales, mins = tq.q4_from_ggml_bytes(raw, (96, 256), ftype)
    _assert_qt_equal(got, tq.repack_codes_tpu(codes, scales, mins))


@pytest.mark.parametrize("ftype", FTYPES)
def test_dequant_bit_identical(ftype):
    """numpy dequantize_tpu and the torch plain dequant (f32) both equal
    bert_tpu.quant.dequantize_tpu bit for bit."""
    qt = tq.quantize_tensor_tpu(_weights(5, (256, 96)), ftype)
    ref = jq.dequantize_tpu(qt)
    np.testing.assert_array_equal(tq.dequantize_tpu(qt), ref)
    qt_t = tq.QuantTensor(torch.from_numpy(qt.packed),
                          torch.from_numpy(qt.scales),
                          None if qt.mins is None
                          else torch.from_numpy(qt.mins))
    np.testing.assert_array_equal(q4_dequantize(qt_t).numpy(), ref)


@pytest.mark.parametrize("ftype", FTYPES)
def test_concat_and_stack_bit_identical(ftype):
    qts = [tq.quantize_tensor_tpu(_weights(6 + i, (128, 64)), ftype)
           for i in range(3)]
    order = np.random.default_rng(0).permutation(192)
    _assert_qt_equal(tq.concat_quant_n(qts, col_order=order),
                     jq.concat_quant_n(qts, col_order=order))
    _assert_qt_equal(tq.stack_quant(qts), jq.stack_quant(qts))


def test_random_named_tensors_identical():
    t_named = t_random_named(TConfig(**SMALL), seed=3)
    j_named = j_random_named(JConfig(**SMALL), seed=3)
    assert list(t_named) == list(j_named)
    for k in t_named:
        np.testing.assert_array_equal(t_named[k], j_named[k])
        assert not t_named[k].flags.writeable


@pytest.mark.parametrize("ftype", [0, 1, 2, 3])
def test_write_ggml_byte_identical(ftype, tmp_path):
    named = t_random_named(TConfig(**SMALL), seed=1)
    tokens = build_fixture_tokens()
    hp = [SMALL[k] for k in ("n_vocab", "n_max_tokens", "n_embd",
                             "n_intermediate", "n_head", "n_layer")]
    t_write_ggml(str(tmp_path / "t.bin"), THParams(*hp, ftype=ftype),
                 tokens, named)
    j_write_ggml(str(tmp_path / "j.bin"), JHParams(*hp, ftype=ftype),
                 tokens, named)
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    mf = t_read_ggml(str(tmp_path / "t.bin"))
    assert mf.vocab_tokens == tokens and len(mf.tensors) == len(named)


def _assert_trees_equal(t_tree, j_tree):
    for part in ("embeddings", "layers"):
        assert set(t_tree[part]) == set(j_tree[part])
        for k, a in t_tree[part].items():
            b = j_tree[part][k]
            if isinstance(a, tq.QuantTensor):
                _assert_qt_equal(a, b)
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=f"{part}.{k}")


@pytest.mark.parametrize("ftype", [0, 2, 3])
def test_loader_matches_bert_tpu(ftype, tmp_path):
    named = t_random_named(TConfig(**SMALL), seed=2)
    hp = [SMALL[k] for k in ("n_vocab", "n_max_tokens", "n_embd",
                             "n_intermediate", "n_head", "n_layer")]
    path = str(tmp_path / "m.bin")
    t_write_ggml(path, THParams(*hp, ftype=ftype), build_fixture_tokens(),
                 named)
    t_loaded, j_loaded = t_load_ggml_model(path), j_load_ggml_model(path)
    assert t_loaded.config.__dict__ == j_loaded.config.__dict__
    assert t_loaded.vocab.tokens == j_loaded.vocab.tokens
    _assert_trees_equal(t_loaded.params, j_loaded.params)
    assert set(t_loaded.load_phases) == {"parse", "emb_dequant", "repack"}


@pytest.mark.parametrize("ftype", [None, 2, 3])
def test_params_from_jax_equals_port_params(ftype):
    """The weight carrier on a JAX tree (as numpy, QuantTensor leaves
    duck-typed) gives the same device state as the port's own
    params_from_named_tensors on the same tensors."""
    named = t_random_named(TConfig(**SMALL), seed=4)
    j_tree = jax.tree_util.tree_map(
        np.asarray, j_params_from_named(named, JConfig(**SMALL),
                                        quantize_ftype=ftype))
    carried = params_from_jax(j_tree, TConfig(**SMALL), device="cpu")
    own = params_to_torch(
        t_params_from_named(named, TConfig(**SMALL), quantize_ftype=ftype),
        device="cpu")
    for part in ("embeddings", "layers"):
        for k, a in carried[part].items():
            b = own[part][k]
            if isinstance(a, tq.QuantTensor):
                for f in ("packed", "scales", "mins"):
                    x, y = getattr(a, f), getattr(b, f)
                    assert (x is None) == (y is None)
                    if x is not None:
                        assert x.dtype == y.dtype and torch.equal(x, y)
            else:
                assert a.dtype == b.dtype and torch.equal(a, b), k


def test_params_from_jax_rejects_foreign_tree():
    with pytest.raises(ValueError):
        params_from_jax({"embeddings": {}, "layers": {"w": np.zeros(1)}},
                        TConfig(**SMALL), device="cpu")

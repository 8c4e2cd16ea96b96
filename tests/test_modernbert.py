"""ModernBERT on the port (bert_tpu_torch/modernbert.py) on the CPU: the
port against the plain reference (tests/plain_modernbert.py) on both
routes, dense and Q4_0; the plain reference against transformers'
ModernBertModel; planted faults; the loader; the token budget; the
attention counters against gpubench's cost model.

A tiny configuration: D 64, 4 heads of 16, 6 layers (layers 0 and 3
global), GeGLU 128, local_attention 8 (a band of +-4), 64 positions, token
lists to 40 tokens, so that the band cuts.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import plain_modernbert  # noqa: E402

from bert_tpu_torch import BertTorch  # noqa: E402
from bert_tpu_torch.batching import (  # noqa: E402
    pick_bucket, plan_batch_sizes, plan_buckets, row_cap)
from bert_tpu_torch.loader import load_model  # noqa: E402
from bert_tpu_torch.quant import dequantize_tpu  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = {"architectures": ["ModernBertModel"], "model_type": "modernbert",
       "hidden_size": 64, "intermediate_size": 128,
       "num_attention_heads": 4, "num_hidden_layers": 6, "vocab_size": 300,
       "max_position_embeddings": 64, "norm_eps": 1e-5,
       "global_attn_every_n_layers": 3, "local_attention": 8,
       "global_rope_theta": 160000.0, "local_rope_theta": 10000.0,
       "hidden_activation": "gelu", "norm_bias": False,
       "attention_bias": False, "mlp_bias": False}
WORDS = ["the", "cat", "sat", "on", "a", "mat", "and", "dog", "ran", "far"]
VOCAB = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
         + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS)
VOCAB += [f"[unused{i}]" for i in range(99, 99 + 300 - len(VOCAB))]
# token lists: [CLS] + words + [SEP], 3 to 40 tokens
LENGTHS = (3, 9, 17, 26, 33, 40)
# f32 on the CPU: the port's plain ops and the reference compute the same
# values in other orders (the attention scales its scores after the
# product, the port's mean and variance are its own), a few ulps of O(1)
TOL = 1e-5


def token_lists(lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    return [[101] + (104 + rng.integers(len(WORDS), size=n - 2)).tolist()
            + [102] for n in lengths]


def weights(cfg=CFG, seed=3):
    """Dense f32 weights under ModernBertModel's names."""
    g = torch.Generator().manual_seed(seed)
    d, f = cfg["hidden_size"], cfg["intermediate_size"]

    def normal(*shape, std=0.05):
        return torch.randn(*shape, generator=g) * std

    w = {"embeddings.tok_embeddings.weight": normal(cfg["vocab_size"], d),
         "embeddings.norm.weight": 1 + normal(d, std=0.1),
         "final_norm.weight": 1 + normal(d, std=0.1)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        if i:
            w[p + "attn_norm.weight"] = 1 + normal(d, std=0.1)
        w[p + "attn.Wqkv.weight"] = normal(3 * d, d, std=0.1)
        w[p + "attn.Wo.weight"] = normal(d, d, std=0.1)
        w[p + "mlp_norm.weight"] = 1 + normal(d, std=0.1)
        w[p + "mlp.Wi.weight"] = normal(2 * f, d, std=0.1)
        w[p + "mlp.Wo.weight"] = normal(d, f, std=0.1)
    return w


def write_safetensors(path, tensors):
    header, off, blobs = {}, 0, []
    for name, t in tensors.items():
        raw = t.float().contiguous().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        off += len(raw)
        blobs.append(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head + b"".join(blobs))


def write_dir(path, w, cfg=CFG, pooling="cls"):
    os.makedirs(os.path.join(path, "1_Pooling"), exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    with open(os.path.join(path, "1_Pooling", "config.json"), "w") as f:
        json.dump({"pooling_mode_cls_token": pooling == "cls",
                   "pooling_mode_mean_tokens": pooling == "mean"}, f)
    write_safetensors(os.path.join(path, "model.safetensors"), w)
    return str(path)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_dir(tmp_path_factory.mktemp("mb") / "m", weights())


def reference(w=None, q4=False, precision="f32", cls=None):
    cfg = dict(CFG, weights={"ftype": "q4_0" if q4 else "f32"})
    cls = cls or plain_modernbert.Reference
    return cls(weights() if w is None else w, cfg, "cpu", precision)


@pytest.fixture(scope="module")
def engines(model_dir):
    """(weights, route) → a CPU engine, f32."""
    out = {}
    for q in ("dense", "q4_0"):
        for route in ("bucketed", "packed"):
            out[q, route] = BertTorch.from_file(
                model_dir, device="cpu",
                quantize_ftype=2 if q == "q4_0" else None,
                packing=route == "packed")
    return out


@pytest.mark.parametrize("route", ["bucketed", "packed"])
@pytest.mark.parametrize("q", ["dense", "q4_0"])
def test_port_matches_plain_reference(engines, route, q):
    eng = engines[q, route]
    toks = token_lists()
    got = eng.eval_tokens(toks)
    want = reference(q4=q == "q4_0").embed(toks).numpy()
    assert np.abs(got - want).max() < TOL
    kinds = {k.split()[-1] for k in eng.stats()["buckets"]}
    assert kinds == ({"packed"} if route == "packed" else {k.split()[0] for
                                                           k in kinds})
    if route == "bucketed":
        assert not any("packed" in k for k in eng.stats()["buckets"])


def test_texts_through_every_entry(engines):
    """encode_batch, encode_iter and eval_tokens agree, on text."""
    eng = engines["q4_0", "bucketed"]
    texts = ["the cat sat on a mat " * k for k in (1, 3, 6)]
    batch = eng.encode_batch(texts)
    it = np.concatenate(list(eng.encode_iter(texts, window=2)))
    toks = [eng.tokenize(t) for t in texts]
    assert toks[0] == [101, 104, 105, 106, 107, 108, 109, 102]
    np.testing.assert_array_equal(batch, it)
    np.testing.assert_allclose(
        batch, reference(q4=True).embed(toks).numpy(), atol=TOL)
    assert eng.pooling == "cls"


def test_server_round_trip(engines):
    """A text on the reference wire through EmbeddingServer."""
    import socket
    import struct

    from bert_tpu_torch.server import ServerThread

    eng = engines["q4_0", "packed"]
    with ServerThread(eng) as st:
        with socket.create_connection(("127.0.0.1", st.port)) as s:
            assert struct.unpack("<i", s.recv(4)) == (64,)
            s.sendall(b"the dog ran far")
            buf = b""
            while len(buf) < 4 * 64:
                buf += s.recv(4 * 64 - len(buf))
    np.testing.assert_allclose(np.frombuffer(buf, "<f4"),
                               eng.encode("the dog ran far"), atol=1e-6)


def test_int8_eval_runs_w8a8(model_dir):
    eng = BertTorch.from_file(model_dir, device="cpu", quantize_ftype=2,
                              int8_eval=True, int8_threshold=0)
    from bert_tpu_torch.ops.int8_matmul import Int8Weight

    assert isinstance(eng.model_int8.layers[0].w("qkv_w"), Int8Weight)
    toks = token_lists()
    got = eng.eval_tokens(toks)
    want = reference(q4=True).embed(toks).numpy()
    gap = np.linalg.norm(got - want, axis=1).max()
    assert 1e-4 < gap < 0.2  # W8A8, not the Q4 tree
    assert eng.stats()["buckets"]


def test_mesh_and_training_refused(model_dir):
    from bert_tpu_torch.model import TrainableBertModel

    loaded = load_model(model_dir)
    with pytest.raises(NotImplementedError, match="training"):
        TrainableBertModel(loaded.params, loaded.config)
    from bert_tpu_torch.modernbert import ModernBertModel
    from bert_tpu_torch.params import params_to_torch

    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        ModernBertModel(params_to_torch(loaded.params, device="cpu"),
                        loaded.config, tp_group=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        BertTorch(loaded, device="cpu", mesh=object())


# -- the plain reference, pinned -------------------------------------------

def _hf_model(w):
    transformers = pytest.importorskip("transformers")
    if not hasattr(transformers, "ModernBertModel"):
        pytest.skip("transformers has no ModernBertModel")
    cfg = transformers.ModernBertConfig(
        **{k: v for k, v in CFG.items() if k not in ("architectures",
                                                     "model_type")},
        attn_implementation="eager", pad_token_id=0, bos_token_id=101,
        eos_token_id=102, cls_token_id=101, sep_token_id=102)
    m = transformers.ModernBertModel(cfg).eval()
    missing, unexpected = m.load_state_dict(w, strict=False)
    assert not unexpected and all("bias" in k for k in missing), missing
    return m


def test_plain_reference_matches_transformers():
    """The identity norm of layer 0, the window inclusive at
    +-local/2, θ by kind of layer, rotate-half, input before gate and the
    final norm, as transformers' ModernBertModel (eager attention, f32)
    computes them."""
    w = weights()
    hf = _hf_model(w)
    ref = reference(w)
    for toks in token_lists():
        ids = torch.tensor([toks])
        with torch.no_grad():
            want = hf(input_ids=ids).last_hidden_state[0]
        got = ref.hidden(torch.tensor(toks))
        assert (got - want).abs().max() < TOL


class _EveryLayerGlobal(plain_modernbert.Reference):
    def is_global(self, layer):
        return True


class _ThetaSwapped(plain_modernbert.Reference):
    def theta(self, layer):
        return (self.theta_local if self.is_global(layer)
                else self.theta_global)


class _Interleaved(plain_modernbert.Reference):
    def rotate(self, x, cos, sin):
        half = x.shape[-1] // 2
        c, s = cos[..., :half], sin[..., :half]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                           dim=-1).flatten(-2)


class _NormOnLayer0(plain_modernbert.Reference):
    def attn_norm(self, x, layer):
        if layer == 0:
            return torch.nn.functional.layer_norm(x, (self.d,), None, None,
                                                  self.eps)
        return super().attn_norm(x, layer)


class _GateSwapped(plain_modernbert.Reference):
    def geglu(self, ug):
        u, g = ug.chunk(2, dim=-1)
        return torch.nn.functional.gelu(g) * u


class _WindowShort(plain_modernbert.Reference):
    def window(self, layer):
        w = super().window(layer)
        return w - 1 if w >= 0 else w


@pytest.mark.parametrize("fault", [_EveryLayerGlobal, _ThetaSwapped,
                                   _Interleaved, _NormOnLayer0, _GateSwapped,
                                   _WindowShort],
                         ids=lambda c: c.__name__.strip("_"))
def test_planted_fault_fails(engines, fault):
    toks = token_lists()
    got = engines["dense", "bucketed"].eval_tokens(toks)
    bad = reference(cls=fault).embed(toks).numpy()
    assert np.abs(got - bad).max() > 100 * TOL


def test_reference_copy_gives_the_same_bits():
    sys.path.insert(0, REPO)
    from gpubench.reference import modernbert as bench_ref

    toks = token_lists()
    for precision in ("f32", "fp8"):
        a = reference(q4=True, precision=precision).embed(toks)
        b = reference(q4=True, precision=precision,
                      cls=bench_ref.Reference).embed(toks)
        assert torch.equal(a, b)


# -- the loader -------------------------------------------------------------

def _masked_lm(w):
    out = {"model." + k: v for k, v in w.items()}
    d = CFG["hidden_size"]
    out.update({"head.dense.weight": torch.ones(d, d),
                "head.norm.weight": torch.ones(d),
                "decoder.bias": torch.zeros(CFG["vocab_size"])})
    return out


@pytest.mark.parametrize("q", [None, 2])
def test_loader_names_give_one_tree(tmp_path, q):
    w = weights()
    plain = load_model(write_dir(tmp_path / "a", w), quantize_ftype=q)
    mlm = load_model(write_dir(tmp_path / "b", _masked_lm(w)),
                     quantize_ftype=q)
    assert plain.config == mlm.config and plain.pooling == "cls"
    for group in ("embeddings", "layers"):
        assert plain.params[group].keys() == mlm.params[group].keys()
        for k, a in plain.params[group].items():
            b = mlm.params[group][k]
            if hasattr(a, "packed"):
                assert np.array_equal(a.packed, b.packed)
                assert np.array_equal(a.scales, b.scales)
            else:
                assert np.array_equal(a, b)
    phases = plain.load_phases
    assert {"parse", "relayout"} <= set(phases)
    assert ("quantize" in phases) == (q is not None)


def test_qkv_relayout_and_quantize_on_load_are_bit_exact(tmp_path):
    w = weights()
    path = write_dir(tmp_path / "m", w)
    dense = load_model(path).params["layers"]
    q4 = load_model(path, quantize_ftype=2).params["layers"]
    d, h = CFG["hidden_size"], CFG["num_attention_heads"]
    dh = d // h
    for i in range(CFG["num_hidden_layers"]):
        wqkv = w[f"layers.{i}.attn.Wqkv.weight"].numpy()  # [q; k; v] rows
        # head-interleaved columns: head h's q, k, v, dh each
        want = wqkv.reshape(3, h, dh, d).transpose(1, 0, 2, 3).reshape(
            3 * d, d).T
        assert np.array_equal(dense["qkv_w"][i], want)
        for key, name in (("qkv_w", None), ("o_w", "attn.Wo"),
                          ("ff_i_w", "mlp.Wi"), ("ff_o_w", "mlp.Wo")):
            qt = q4[key]
            got = dequantize_tpu(type(qt)(packed=qt.packed[i],
                                          scales=qt.scales[i], mins=None))
            src = (torch.from_numpy(np.ascontiguousarray(want.T))
                   if name is None else w[f"layers.{i}.{name}.weight"])
            ref = plain_modernbert.q4_0_roundtrip(src).numpy().T
            assert np.array_equal(got, ref), key


def test_layer0_attn_norm_is_refused(tmp_path):
    w = weights()
    w["layers.0.attn_norm.weight"] = torch.ones(CFG["hidden_size"])
    with pytest.raises(ValueError, match="layer 0"):
        load_model(write_dir(tmp_path / "m", w))


def test_weight_cache_round_trip(engines, tmp_path):
    eng = engines["q4_0", "bucketed"]
    path = str(tmp_path / "mb.npz")
    eng.save_cache(path)
    again = BertTorch.from_file(path, device="cpu", packing=False)
    assert again.config == eng.config and again.pooling == "cls"
    toks = token_lists()
    np.testing.assert_array_equal(again.eval_tokens(toks),
                                  eng.eval_tokens(toks))


# -- the token budget -------------------------------------------------------

def test_budget_leaves_512_position_plans_unchanged():
    rng = np.random.default_rng(5)
    for n in (1, 7, 130, 300, 1000):
        lengths = rng.integers(1, 513, size=n).tolist()
        buckets = [16, 32, 64, 128, 256, 512]
        assert all(row_cap(s, 128) == 128 for s in buckets)
        plan = plan_buckets(lengths, buckets, 128, 1)
        # max_batch's plan alone: each bucket's rows in plan_batch_sizes
        by = {}
        for i, n in enumerate(lengths):
            by.setdefault(pick_bucket(n, buckets), []).append(i)
        want = [(s, bb) for s in sorted(by)
                for bb in plan_batch_sizes(len(by[s]), 128, 1)]
        assert [(s, bb) for s, bb, _ in plan.groups] == want
        assert plan.budget_splits == 0


def _warm_shapes(eng, **kw):
    shapes = []
    eng._warm_shape = lambda r, s, k: shapes.append((r, s, k))
    eng.warmup(**kw)
    return shapes


def test_budget_leaves_512_position_warmup_unchanged(model_dir, tmp_path):
    from bert_tpu_torch.params import BertConfig, random_named_tensors
    from bert_tpu_torch.formats.ggml_bin import GgmlHParams, write_ggml

    cfg = BertConfig(n_vocab=300, n_max_tokens=512, n_embd=32,
                     n_intermediate=64, n_head=2, n_layer=1)
    path = str(tmp_path / "b.bin")
    write_ggml(path, GgmlHParams(300, 512, 32, 64, 2, 1, 0), VOCAB,
               random_named_tensors(cfg))
    base = BertTorch.from_file(path, device="cpu")
    unbounded = BertTorch.from_file(path, device="cpu")
    unbounded._row_cap = lambda seq, minimum: unbounded.max_batch
    assert base._row_cap(512, 1) == base.max_batch == 128
    manifest = [{"rows": r, "seq": s} for r in (1, 8, 100, 128)
                for s in (16, 200, 512)]
    for kw in ({}, {"manifest": manifest}):
        assert _warm_shapes(base, **kw) == _warm_shapes(unbounded, **kw)


def test_budget_caps_rows_at_8192_positions(tmp_path):
    cfg = dict(CFG, max_position_embeddings=8192)
    path = write_dir(tmp_path / "m", weights(cfg), cfg)
    eng = BertTorch.from_file(path, device="cpu")
    plan = plan_buckets([8000] * 20 + [1000] * 70, eng.seq_buckets,
                        eng.max_batch, 1)
    assert [(s, b) for s, b, _ in plan.groups] == [
        (1024, 64), (1024, 8), (8192, 8), (8192, 8), (8192, 4)]
    # max_batch alone would make 64 + 8 of the 70 rows at 1,024 too, and
    # 16 + 4 of the 20 at 8,192: the budget split only those
    assert plan.budget_splits == 1
    for kw in ({}, {"manifest": [{"rows": r, "seq": s}
                                 for r in (1, 8, 16, 64, 128)
                                 for s in (512, 4096, 8192)]}):
        shapes = _warm_shapes(eng, **kw)
        assert shapes and all(r * s <= 65536 for r, s, _ in shapes)
        assert (8, 8192, "bucketed") in shapes
    grid = _warm_shapes(eng)
    assert (128, 512, "bucketed") in grid and (64, 1024, "bucketed") in grid


# -- RoPE's pass ------------------------------------------------------------

def test_rope_pass_is_the_reference_rotation():
    """``rope_qkv_plain``, which the card's RoPE pass matches bit for bit
    (chip_smoke.py), rotates q and k as the plain reference does, bit for
    bit in f32, with either θ; v stays as it was; at positions that
    restart, each segment is rotated as a row of its own."""
    from bert_tpu_torch.ops.fused_attention import (rope_qkv_plain,
                                                    rope_tables)

    ref = plain_modernbert.Reference(weights(), CFG, "cpu")
    h = CFG["num_attention_heads"]
    dh = CFG["hidden_size"] // h
    b, t = 2, 40
    qkv = torch.randn(b, t, 3 * h * dh,
                      generator=torch.Generator().manual_seed(11))
    x = qkv.reshape(b, t, h, 3, dh)
    for layer in (0, 1):
        cos, sin = rope_tables(ref.theta(layer), dh, 64)
        rc, rs = ref._rope(layer, t)
        got = rope_qkv_plain(qkv, cos, sin, n_head=h,
                             d_head=dh).reshape(b, t, h, 3, dh)
        for i in range(2):
            want = ref.rotate(x[:, :, :, i].transpose(1, 2), rc,
                              rs).transpose(1, 2)
            assert torch.equal(got[:, :, :, i], want)
        assert torch.equal(got[:, :, :, 2], x[:, :, :, 2])
    pos = (torch.arange(t) % 20).to(torch.int32).repeat(b, 1)
    got = rope_qkv_plain(qkv, cos, sin, pos, n_head=h, d_head=dh)
    halves = [rope_qkv_plain(qkv[:, i:i + 20].contiguous(), cos, sin,
                             n_head=h, d_head=dh) for i in (0, 20)]
    assert torch.equal(got, torch.cat(halves, dim=1))


# -- the attention counters against gpubench's cost model -------------------

@pytest.mark.parametrize("packing", [False, True])
def test_attention_counts_match_the_cost_model(model_dir, packing):
    sys.path.insert(0, REPO)
    from gpubench.costs import attention as costs

    from bert_tpu_torch.ops.fused_attention import band_bias

    eng = BertTorch.from_file(model_dir, device="cpu", packing=packing)
    eng.eval_tokens(token_lists() + token_lists((40, 5, 12), seed=1))
    st = eng.stats()
    w = CFG["local_attention"] // 2
    want = {}
    for key, n in st["buckets"].items():
        shape = key.split()[0]  # packed and bucketed batches add up
        want[f"full {shape}"] = want.get(f"full {shape}", 0) + 2 * n
        want[f"band {shape}"] = want.get(f"band {shape}", 0) + 4 * n
    assert st["attention"] == want  # layers 0 and 3 full, the others band
    assert any(k.endswith("packed") for k in st["buckets"]) == packing
    h, dh = CFG["num_attention_heads"], 64 // CFG["num_attention_heads"]
    for key, n in st["attention"].items():
        kind, shape = key.split()
        rows, t = (int(v) for v in shape.split("x"))
        window = w if kind == "band" else 0
        admitted = (int(torch.isfinite(band_bias(t, window)).sum())
                    if window else t * t)
        assert costs.pairs(t, window) == admitted
        assert costs.ops(rows, t, h, dh, window) == 4.0 * rows * h * dh * \
            admitted

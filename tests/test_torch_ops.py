"""The port's ops on the CPU against bert_tpu's, on the same inputs.

Each op's plain PyTorch version (what the wrapper runs for CPU tensors) is
held against both JAX versions: the jnp reference the JAX model runs on a
CPU, and the Pallas kernel run in interpret mode, as tests/test_kernels.py
runs it. Inputs are made from a seed with numpy; bf16 inputs are the same
f32 values rounded (round-to-nearest-even on both sides).

Tolerances: f32 against the jnp reference 1e-5 (the same f32 arithmetic,
summed in another order); f32 against interpret mode 1e-4 (the Pallas
kernels round in another order: LayerNorm widens before its adds, the
attention kernel folds 1/sqrt(dh) into q and defers the softmax
normalization); bf16 2e-2 (one bf16 rounding of an O(1) value is 4e-3,
and the two frameworks round at different places). The CUDA kernels
themselves are checked against these plain versions on the card by
chip_smoke.py; CUDA has no interpret mode.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bert_tpu.ops.attention import _mha_jnp
from bert_tpu.ops.fused_attention import fused_qkv_attention as j_fused_attn
from bert_tpu.ops.layer_norm import _ln_pallas, layer_norm_jnp
from bert_tpu.ops.q4_matmul import _q4_matmul_jnp, _q4_matmul_pallas
from bert_tpu.quant import quantize_tensor_tpu
from bert_tpu_torch import _kernels
from bert_tpu_torch.ops.fused_attention import (
    _check_alignment as _check_attention_alignment,
    attention_plain,
    fused_qkv_attention,
)
from bert_tpu_torch.ops.layer_norm import (
    _check_alignment,
    fused_layer_norm,
    layer_norm_plain,
    vector_width,
)
from bert_tpu_torch.ops.q4_matmul import (
    _check_alignment as _check_q4_alignment,
    load_alignment,
    fused_max_m,
    q4_matmul,
    q4_matmul_plain,
)
from bert_tpu_torch.quant import QuantTensor

# One intra-op thread: the suite runs several test files at once, and
# torch's default pool (one thread per core, in every worker) starves
# the timing-sensitive tests running beside these.
torch.set_num_threads(1)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL_JNP = {"f32": 1e-5, "bf16": 2e-2}
TOL_INTERPRET = {"f32": 1e-4, "bf16": 2e-2}


def _pair(a: np.ndarray, dname: str):
    """The same values as a torch tensor and a jax array of dtype dname."""
    td, jd = DTYPES[dname]
    return torch.from_numpy(a).to(td), jnp.asarray(a).astype(jd)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("ftype", [2, 3])
def test_q4_matmul_plain_matches_jax(ftype, dname):
    # M not a multiple of 8, N not a multiple of 128
    rng = np.random.default_rng(10 + ftype)
    m, k, n = 13, 128, 200
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    qt = quantize_tensor_tpu(w, ftype)
    xt, xj = _pair(rng.standard_normal((m, k)).astype(np.float32), dname)
    qt_t = QuantTensor(torch.from_numpy(qt.packed),
                       torch.from_numpy(qt.scales),
                       None if qt.mins is None else torch.from_numpy(qt.mins))
    got = q4_matmul(xt, qt_t)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.equal(got, q4_matmul_plain(xt, qt_t))  # CPU → plain
    _close(got, _q4_matmul_jnp(xj, qt), TOL_JNP[dname])
    pallas = _q4_matmul_pallas(
        xj, jnp.asarray(qt.packed), jnp.asarray(qt.scales),
        None if qt.mins is None else jnp.asarray(qt.mins), interpret=True)
    _close(got, pallas, TOL_INTERPRET[dname])


# The bf16 kernel's edges: one row, N % 16 != 0 (4-byte band loads), and
# FFN-down's K = 1536. In bf16 the Pallas kernel rounds each f32 weight
# once where the plain version rounds scale and product one by one (ROADMAP
# section C); the difference grows with sqrt(K), so at K = 1536 the plain
# version is held to interpret mode at chip_smoke.py's q4 bf16 tolerance.
TOL_Q4_EDGE_INTERPRET = {"f32": 1e-4, "bf16": 5e-2}


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("ftype", [2, 3])
@pytest.mark.parametrize("shape", [(1, 128, 200), (1, 1536, 200),
                                   (37, 1536, 384)],
                         ids=["m1_n200", "m1_k1536", "k1536"])
def test_q4_matmul_plain_matches_jax_at_kernel_edges(shape, ftype, dname):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n + ftype)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    qt = quantize_tensor_tpu(w, ftype)
    xt, xj = _pair(rng.standard_normal((m, k)).astype(np.float32), dname)
    qt_t = QuantTensor(torch.from_numpy(qt.packed),
                       torch.from_numpy(qt.scales),
                       None if qt.mins is None else torch.from_numpy(qt.mins))
    got = q4_matmul(xt, qt_t)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _close(got, _q4_matmul_jnp(xj, qt), TOL_JNP[dname])
    pallas = _q4_matmul_pallas(
        xj, jnp.asarray(qt.packed), jnp.asarray(qt.scales),
        None if qt.mins is None else jnp.asarray(qt.mins), interpret=True)
    _close(got, pallas, TOL_Q4_EDGE_INTERPRET[dname])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q4_router_keeps_every_path_shape_on_the_kernel(dtype):
    # the main path's largest M is 1,024 rows (16x64 packed, 8x128); the
    # kernel checks go up to 2,048 (M=2048 K=1024 N=4096) in both dtypes
    assert fused_max_m(dtype) >= 2048
    assert fused_max_m(torch.bfloat16) >= fused_max_m(torch.float32)


@pytest.mark.parametrize("n, want", [
    (1152, {"x": 16, "packed": 16, "scales": 16, "mins": 16}),
    (200, {"x": 16, "packed": 4, "scales": 16, "mins": 16}),
    (201, {"x": 16, "packed": 1, "scales": 4, "mins": 4})])
def test_q4_bf16_alignment_follows_the_row_stride(n, want):
    assert load_alignment(n) == want
    k = 64
    buf = torch.zeros(k // 2 * n + 16, dtype=torch.uint8)
    scales = torch.zeros(k // 32 * n + 4)
    qt = QuantTensor(buf[:k // 2 * n].view(k // 2, n),
                     scales[:k // 32 * n].view(k // 32, n), None)
    x = torch.zeros(2 * k + 8, dtype=torch.bfloat16)
    _check_q4_alignment(x[:2 * k].view(2, k), qt)  # fresh buffers: aligned
    with pytest.raises(ValueError, match="x at"):
        _check_q4_alignment(x[1:1 + 2 * k].view(2, k), qt)
    if want["packed"] > 1:  # a per-layer slice that starts off the width
        off = QuantTensor(buf[1:1 + k // 2 * n].view(k // 2, n),
                          qt.scales, None)
        with pytest.raises(ValueError, match="packed at"):
            _check_q4_alignment(x[:2 * k].view(2, k), off)
    off = QuantTensor(qt.packed, scales[1:1 + k // 32 * n].view(k // 32, n),
                      None)
    if want["scales"] > 4:
        with pytest.raises(ValueError, match="scales at"):
            _check_q4_alignment(x[:2 * k].view(2, k), off)


def test_fused_attention_bf16_alignment_is_checked():
    b, t, h, dh = 2, 8, 2, 32
    qkv = torch.zeros(b * t * 3 * h * dh + 8, dtype=torch.bfloat16)
    bias = torch.zeros(b * t + 2)
    ok_qkv = qkv[:b * t * 3 * h * dh].view(b, t, 3 * h * dh)
    _check_attention_alignment(ok_qkv, bias[:b * t].view(b, t))
    with pytest.raises(ValueError, match="qkv at"):
        _check_attention_alignment(
            qkv[1:1 + b * t * 3 * h * dh].view(b, t, 3 * h * dh),
            bias[:b * t].view(b, t))
    with pytest.raises(ValueError, match="mask_bias at"):
        _check_attention_alignment(ok_qkv, bias[1:1 + b * t].view(b, t))


# 37x128 as before; D = 312 (rubert-tiny2), 1280 (past a row in registers:
# the kernel's block-per-row instance) and 129 (odd: its scalar path)
LN_SHAPES = [(37, 128), (37, 312), (9, 1280), (5, 129)]
LN_IDS = ["37x128", "37x312", "9x1280", "5x129"]


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["plain", "residual", "residual_pre_bias"])
@pytest.mark.parametrize("shape", LN_SHAPES, ids=LN_IDS)
def test_fused_layer_norm_plain_matches_jax(shape, form, dname):
    rng = np.random.default_rng(20)
    m, d = shape
    xt, xj = _pair(rng.standard_normal((m, d)).astype(np.float32), dname)
    scale = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    rt = rj = pbt = pbj = None
    if form != "plain":
        rt, rj = _pair(rng.standard_normal((m, d)).astype(np.float32), dname)
    if form == "residual_pre_bias":
        pb = rng.standard_normal(d).astype(np.float32)
        pbt, pbj = torch.from_numpy(pb), jnp.asarray(pb)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    sj, bj = jnp.asarray(scale), jnp.asarray(bias)
    got = fused_layer_norm(xt, st, bt, eps=1e-12, residual=rt, pre_bias=pbt)
    assert got.dtype == xt.dtype
    assert torch.equal(got, layer_norm_plain(xt, st, bt, 1e-12, rt, pbt))
    _close(got, layer_norm_jnp(xj, sj, bj, 1e-12, rj, pbj), TOL_JNP[dname])
    pallas = _ln_pallas(xj, sj, bj, 1e-12, rj, pbj, interpret=True)
    _close(got, pallas, TOL_INTERPRET[dname])


@pytest.mark.parametrize("form", ["plain", "residual", "residual_pre_bias"])
@pytest.mark.parametrize("shape", LN_SHAPES[:2], ids=LN_IDS[:2])
def test_fused_layer_norm_f32_input_rounds_first(shape, form):
    """The f32-input form (x an f32 matmul product, residual and output
    bf16) is x.to(bf16) followed by the bf16 LayerNorm, exactly; against
    bert_tpu it is the bf16 LayerNorm of x.astype(bf16)."""
    rng = np.random.default_rng(21)
    m, d = shape
    x = rng.standard_normal((m, d)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x).astype(jnp.bfloat16)
    rt = rj = pbt = pbj = None
    if form != "plain":
        rt, rj = _pair(rng.standard_normal((m, d)).astype(np.float32), "bf16")
    if form == "residual_pre_bias":
        pb = rng.standard_normal(d).astype(np.float32)
        pbt, pbj = torch.from_numpy(pb), jnp.asarray(pb)
    scale = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    sj, bj = jnp.asarray(scale), jnp.asarray(bias)
    got = fused_layer_norm(xt, st, bt, eps=1e-12, residual=rt, pre_bias=pbt,
                           out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fused_layer_norm(xt.to(torch.bfloat16), st, bt,
                                             eps=1e-12, residual=rt,
                                             pre_bias=pbt))
    _close(got, layer_norm_jnp(xj, sj, bj, 1e-12, rj, pbj), TOL_JNP["bf16"])
    pallas = _ln_pallas(xj, sj, bj, 1e-12, rj, pbj, interpret=True)
    _close(got, pallas, TOL_INTERPRET["bf16"])


@pytest.mark.parametrize("d, out_dtype, width", [
    (384, torch.bfloat16, 8), (130, torch.bfloat16, 2),
    (129, torch.bfloat16, 1), (384, torch.float32, 4),
    (130, torch.float32, 1)])
def test_fused_layer_norm_alignment_is_checked(d, out_dtype, width):
    """The kernel moves rows of D in vectors of 16 bytes, 4 bytes or one
    element by D and the output type; each operand must be aligned for
    its row's vector, min(16, width * element size) bytes, or the wrapper
    raises (f32 x beside a bf16 output needs twice the bf16 alignment)."""
    assert vector_width(d, out_dtype) == width
    m = 2
    xbuf = torch.zeros(m * d + 8, dtype=torch.float32)
    rbuf = torch.zeros(m * d + 8, dtype=out_dtype)
    pbuf = torch.zeros(d + 8)
    x, r = xbuf[:m * d].view(m, d), rbuf[:m * d].view(m, d)
    p = pbuf[:d]
    _check_alignment(x, r, p, p, p, out_dtype)  # fresh buffers: aligned
    _check_alignment(x, None, None, p, p, out_dtype)
    if width == 1:
        return  # one element a vector: every pointer is aligned by its type
    for name, args in (
            ("x", (xbuf[1:1 + m * d].view(m, d), r, p, p, p)),
            ("residual", (x, rbuf[1:1 + m * d].view(m, d), p, p, p)),
            ("pre_bias", (x, r, pbuf[1:1 + d], p, p)),
            ("scale", (x, r, p, pbuf[1:1 + d], p)),
            ("bias", (x, r, p, p, pbuf[1:1 + d]))):
        with pytest.raises(ValueError, match=f"{name} at"):
            _check_alignment(*args, out_dtype)


def _attention_inputs(rng, b, t, h, dh, pairwise):
    qkv = rng.standard_normal((b, t, 3 * h * dh)).astype(np.float32)
    if pairwise:  # two packed segments per row, row 0 all padding
        seg = np.where(np.arange(t) < t // 2, 1, 2)[None].repeat(b, 0)
        seg[0] = 0
        same = seg[:, :, None] == seg[:, None, :]
        bias = np.where(same & (seg > 0)[:, None, :], 0.0, -1e9)
    else:  # key-side padding, row 0 fully masked
        mask = (rng.random((b, t)) > 0.3).astype(np.float32)
        mask[1:, 0] = 1.0
        mask[0] = 0.0
        bias = (mask - 1.0) * 1e9
    return qkv, bias.astype(np.float32)


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("pairwise", [False, True],
                         ids=["key_side", "pairwise"])
def test_fused_qkv_attention_plain_matches_jax(pairwise, dname):
    rng = np.random.default_rng(30 + pairwise)
    b, t, h, dh = 3, 16, 4, 32
    qkv, bias = _attention_inputs(rng, b, t, h, dh, pairwise)
    qt, qj = _pair(qkv, dname)
    bt, bj = torch.from_numpy(bias), jnp.asarray(bias)
    scale = 1.0 / dh ** 0.5
    got = fused_qkv_attention(qt, bt, n_head=h, d_head=dh, scale=scale)
    assert got.shape == (b, t, h * dh) and got.dtype == qt.dtype
    assert torch.isfinite(got).all()  # fully masked rows: uniform, no NaN
    assert torch.equal(got, attention_plain(qt, bt, n_head=h, d_head=dh,
                                            scale=scale))
    # the jnp reference on the head-split layout, as the JAX model runs it
    q5 = qj.reshape(b, t, h, 3, dh).transpose(0, 2, 3, 1, 4)
    ref = _mha_jnp(q5[:, :, 0], q5[:, :, 1], q5[:, :, 2], bj, scale)
    _close(got, ref.transpose(0, 2, 1, 3).reshape(b, t, h * dh),
           TOL_JNP[dname])
    # the Pallas kernel packs G batch rows into one score tile, so a fully
    # masked query row there averages over the whole group (an output the
    # JAX model discards); jnp and the port average over the row's own
    # keys. Hold the kernel to the rows that have a key to attend to.
    pallas = j_fused_attn(qj, bj, n_head=h, d_head=dh, scale=scale,
                          head_chunk=None, interpret=True)
    live = (bias == 0).any(axis=-1)
    live = live if pairwise else live[:, None].repeat(t, 1)  # [B, T]
    assert live.any() and not live.all()
    np.testing.assert_allclose(_np(got)[live], _np(pallas)[live],
                               atol=TOL_INTERPRET[dname],
                               rtol=TOL_INTERPRET[dname])


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("pairwise", [False, True],
                         ids=["key_side", "pairwise"])
@pytest.mark.parametrize("t, dh", [(37, 32), (100, 64)],
                         ids=["t37", "t100"])
def test_fused_qkv_attention_plain_matches_jax_at_ragged_t(t, dh, pairwise,
                                                          dname):
    """T off the 64-key tiles of the bf16 kernel, with fully masked rows in
    both bias forms (row 0 of the batch)."""
    rng = np.random.default_rng(t + dh + pairwise)
    b, h = 2, 3
    qkv, bias = _attention_inputs(rng, b, t, h, dh, pairwise)
    qt, qj = _pair(qkv, dname)
    bt, bj = torch.from_numpy(bias), jnp.asarray(bias)
    scale = 1.0 / dh ** 0.5
    got = fused_qkv_attention(qt, bt, n_head=h, d_head=dh, scale=scale)
    assert got.shape == (b, t, h * dh) and got.dtype == qt.dtype
    assert torch.isfinite(got).all()
    q5 = qj.reshape(b, t, h, 3, dh).transpose(0, 2, 3, 1, 4)
    ref = _mha_jnp(q5[:, :, 0], q5[:, :, 1], q5[:, :, 2], bj, scale)
    _close(got, ref.transpose(0, 2, 1, 3).reshape(b, t, h * dh),
           TOL_JNP[dname])
    # fully masked rows: the mean of the row's own values
    v = qt.float().reshape(b, t, h, 3, dh)[0, :, :, 2].mean(dim=0)
    masked = got[0].float().reshape(t, h, dh)[~(bias[0] == 0).any(-1)
                                               if pairwise else slice(None)]
    assert masked.shape[0] > 0
    np.testing.assert_allclose(masked.numpy(),
                               v.expand_as(masked).numpy(),
                               atol=TOL_JNP[dname], rtol=TOL_JNP[dname])
    # interpret mode on the rows with a live key (see above)
    pallas = j_fused_attn(qj, bj, n_head=h, d_head=dh, scale=scale,
                          head_chunk=None, interpret=True)
    live = (bias == 0).any(axis=-1)
    live = live if pairwise else live[:, None].repeat(t, 1)
    assert live.any() and not live.all()
    np.testing.assert_allclose(_np(got)[live], _np(pallas)[live],
                               atol=TOL_INTERPRET[dname],
                               rtol=TOL_INTERPRET[dname])


def test_fully_masked_row_is_uniform():
    """NEG_INF is finite: a fully masked query row averages every value
    row, as the JAX kernels do — no -inf, no NaN."""
    rng = np.random.default_rng(40)
    b, t, h, dh = 1, 8, 2, 32
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * h * dh))
                           .astype(np.float32))
    bias = torch.full((b, t), -1e9)
    ctx = fused_qkv_attention(qkv, bias, n_head=h, d_head=dh, scale=0.1)
    v = qkv.reshape(b, t, h, 3, dh)[:, :, :, 2]  # [B, T, H, dh]
    want = v.mean(dim=1, keepdim=True).expand(b, t, h, dh)
    np.testing.assert_allclose(ctx.numpy(), want.reshape(b, t, h * dh),
                               atol=1e-6)


def test_wrappers_raise_on_other_devices():
    x = torch.zeros(2, 64, device="meta")
    with pytest.raises(ValueError):
        fused_layer_norm(x, torch.ones(64), torch.zeros(64), eps=1e-12)


@pytest.mark.parametrize("name", sorted(_kernels.SIGNATURES))
def test_kernel_signatures_match_their_sources(name):
    """Each ctypes signature in ``_kernels.SIGNATURES`` names a C entry
    point of ``csrc/<name>.cu`` with as many parameters: the library is
    built and bound only on the card, where a wrong count would pass
    garbage for every argument after it."""
    with open(os.path.join(_kernels.SRC_DIR, name + ".cu")) as f:
        src = f.read()
    entries = {
        m.group(1): [p for p in m.group(2).split(",") if p.strip()]
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert sorted(entries) == sorted(_kernels.SIGNATURES[name])
    for fn, argtypes in _kernels.SIGNATURES[name].items():
        assert len(entries[fn]) == len(argtypes), fn

"""The f32 kernels' split arithmetic on the CPU, against bert_tpu's f32.

The f32 instances of ``csrc/q4_matmul.cu``, ``csrc/fused_attention.cu`` and
``csrc/attention.cu`` take bert_tpu's ``Precision.HIGHEST``
(bert_tpu/ops/common.py:14-25) as the TPU's matrix unit does: each f32
operand split into three bf16 parts (``testing.split_bf16x3``), six bf16 ×
bf16 products summed in f32 (``testing.matmul_bf16x6``). CUDA has no
interpret mode, so the kernels themselves are held to their plain
versions on the card by chip_smoke.py; here the same arithmetic, written
out in PyTorch, is held to bert_tpu's f32 results on the same numpy
inputs.

Tolerances: (b) 1e-5·(1 + |ref|) against ``_q4_matmul_jnp`` (true f32 on
the CPU; both sides are f32-grade and differ by their roundings, about
1e-6 here); (c) 1e-5 against the attention bert_tpu's model runs off the
TPU (``_mha_jnp``) and against its fused Pallas kernel in interpret mode;
(e) the per-(batch, head) attention's arithmetic (head dims 1-256; q·kᵀ
in six products, then the scale, then the bias, p normalised in f32, p·v
in six products) 1e-5 against ``_mha_jnp`` and, key-side, against the
Pallas ``_mha_kernel`` in interpret mode.
Weights are drawn at scale 0.1, where (d)'s three-product variant (bf16x3)
misses (b)'s tolerance several times over: the test fails a kernel that
drops terms. For the attention, (e)'s inputs (q and k of std 1) leave
the three-product variant within a factor of two of 1e-5 (0.4-1.8 times
it); at q and k of std 2 (logits of std ~4) it misses by more than four
times, and (d) holds it there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bert_tpu.ops.attention import _mha_jnp, _mha_pallas
from bert_tpu.ops.fused_attention import fused_qkv_attention as j_fused_attn
from bert_tpu.ops.q4_matmul import _q4_matmul_jnp
from bert_tpu.quant import quantize_tensor_tpu
from bert_tpu_torch.ops.q4_matmul import q4_dequantize
from bert_tpu_torch.quant import QuantTensor
from bert_tpu_torch.testing import (BF16X6_PASSES, matmul_bf16x6,
                                    split_bf16x3)

torch.set_num_threads(1)  # the suite runs several files at once

TOL = 1e-5
W_SCALE = 0.1


def _parts_sum(x: torch.Tensor) -> np.ndarray:
    return sum(p.double().numpy() for p in split_bf16x3(x))


def _f32_with_exponents(rng) -> np.ndarray:
    """Random 24-bit significands at every exponent from -100 to 100."""
    e = np.repeat(np.arange(-100, 101), 8)
    sig = 1.0 + rng.integers(0, 2 ** 23, size=e.size) / 2.0 ** 23
    sign = rng.choice([-1.0, 1.0], size=e.size)
    return (sign * np.ldexp(sig, e)).astype(np.float32)


def _near_bf16_ties(rng) -> np.ndarray:
    """f32 values with exponents in -100..100 on a tie of the first
    rounding (low 16 bits 0x8000) or of the second (low 8 bits 0x80), and
    one ulp either side of each."""
    exp = rng.integers(127 - 100, 127 + 101, size=64).astype(np.uint32)
    top = ((exp << 7) | rng.integers(0, 128, size=64).astype(np.uint32)) << 16
    sign = rng.choice([0, 0x80000000], size=64).astype(np.uint32)
    mid = rng.integers(0, 256, size=64).astype(np.uint32) << 8
    ties = np.concatenate([top | 0x8000, top | mid | 0x80]) | np.tile(sign, 2)
    bits = np.concatenate([ties, ties + 1, ties - 1]).astype(np.uint32)
    return bits.view(np.float32)


@pytest.mark.parametrize("kind", ["exponents", "zeros", "ties"])
def test_split_bf16x3_is_exact(kind):
    """(a) hi + mid + lo == x exactly (summed in f64), hi is x rounded to
    bf16 (nearest even), and each part is at most half an ulp of the one
    before."""
    rng = np.random.default_rng(1)
    x = {"exponents": lambda: _f32_with_exponents(rng),
         "zeros": lambda: np.array([0.0, -0.0], np.float32),
         "ties": lambda: _near_bf16_ties(rng)}[kind]()
    xt = torch.from_numpy(x)
    hi, mid, lo = split_bf16x3(xt)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(_parts_sum(xt), x.astype(np.float64))
    assert torch.equal(hi, xt.to(torch.bfloat16))
    for big, small in ((hi, mid), (mid, lo)):
        ulp = torch.where(big == 0, torch.zeros_like(big.float()),
                          big.float().abs() * 2.0 ** -7)
        assert bool((small.float().abs() <= ulp).all())
    if kind == "zeros":
        assert all(bool((p == 0).all()) for p in (hi, mid, lo))


def _q4_case(ftype, k, m, n):
    rng = np.random.default_rng(100 * ftype + k + m + n)
    w = (rng.standard_normal((k, n)) * W_SCALE).astype(np.float32)
    qt = quantize_tensor_tpu(w, ftype)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref = np.asarray(_q4_matmul_jnp(jnp.asarray(x), qt))
    wt = q4_dequantize(QuantTensor(
        *(None if a is None else torch.from_numpy(a)
          for a in (qt.packed, qt.scales, qt.mins))))
    return torch.from_numpy(x), wt, ref


def _worst(got: torch.Tensor, ref: np.ndarray) -> float:
    """The largest |got - ref| / (TOL · (1 + |ref|)): ≤ 1 passes."""
    return float(np.max(np.abs(got.numpy() - ref) / (TOL * (1 + np.abs(ref)))))


# M, N at the kernel's ragged edges: M off its 32- and 64-row tiles; N
# odd (byte-wide band loads) and N % 16 != 0 (4-byte band loads)
@pytest.mark.parametrize("m, n", [(37, 201), (65, 200)], ids=["37x201",
                                                               "65x200"])
@pytest.mark.parametrize("k", [384, 1536])
@pytest.mark.parametrize("ftype", [2, 3], ids=["q4_0", "q4_1"])
def test_matmul_bf16x6_matches_q4_matmul_jnp(ftype, k, m, n):
    """(b) Six products against bert_tpu's f32 Q4 matmul."""
    x, w, ref = _q4_case(ftype, k, m, n)
    got = matmul_bf16x6(x, w)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _worst(got, ref) <= 1.0


def _attention_bf16x6(qkv, bias, n_head, d_head, scale):
    """The f32 fused kernel's arithmetic: q scaled in f32, s = q·kᵀ in six
    products + bias, e = exp(s - max) in f32, context = (e·v in six
    products) / sum(e)."""
    b, t, _ = qkv.shape
    q5 = qkv.reshape(b, t, n_head, 3, d_head).permute(0, 2, 3, 1, 4)
    q = q5[:, :, 0] * torch.tensor(scale, dtype=torch.float32)
    s = matmul_bf16x6(q, q5[:, :, 1].transpose(-1, -2))
    s = s + (bias[:, None] if bias.dim() == 3 else bias[:, None, None, :])
    e = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    ctx = matmul_bf16x6(e, q5[:, :, 2]) / e.sum(dim=-1, keepdim=True)
    return ctx.permute(0, 2, 1, 3).reshape(b, t, n_head * d_head)


def _attention_inputs(rng, b, t, h, dh, pairwise):
    qkv = rng.standard_normal((b, t, 3 * h * dh)).astype(np.float32)
    if pairwise:  # two packed segments a row; row 0's last quarter padding
        seg = (np.arange(t) >= t // 2).astype(np.int32) + 1
        seg = np.repeat(seg[None], b, 0)
        seg[0, t - t // 4:] = 0
        same = (seg[:, :, None] == seg[:, None, :]) & (seg > 0)[:, None, :]
        bias = np.where(same, 0.0, -1e9)
    else:  # key-side padding; row 1 of the batch all padding
        mask = (rng.random((b, t)) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
        mask[1] = 0.0
        bias = (mask - 1.0) * 1e9
    return qkv, bias.astype(np.float32)


@pytest.mark.parametrize("t", [37, 64, 512])
@pytest.mark.parametrize("pairwise", [False, True],
                         ids=["key_side", "pairwise"])
@pytest.mark.parametrize("dh", [32, 64])
def test_attention_bf16x6_matches_jax(dh, pairwise, t):
    """(c) Both dots in six products against bert_tpu's f32 attention:
    ``_mha_jnp`` (the model's route off the TPU) everywhere, and the fused
    Pallas kernel in interpret mode on the query rows with a live key (it
    packs G batch rows into one score tile, so a fully masked row there
    averages over the group, an output the model discards)."""
    rng = np.random.default_rng(t + dh + pairwise)
    b, h = 2, 2
    qkv, bias = _attention_inputs(rng, b, t, h, dh, pairwise)
    scale = 1.0 / dh ** 0.5
    got = _attention_bf16x6(torch.from_numpy(qkv), torch.from_numpy(bias),
                            h, dh, scale).numpy()
    qj, bj = jnp.asarray(qkv), jnp.asarray(bias)
    q5 = qj.reshape(b, t, h, 3, dh).transpose(0, 2, 3, 1, 4)
    ref = np.asarray(_mha_jnp(q5[:, :, 0], q5[:, :, 1], q5[:, :, 2], bj,
                              scale).transpose(0, 2, 1, 3)
                     .reshape(b, t, h * dh))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    pallas = np.asarray(j_fused_attn(qj, bj, n_head=h, d_head=dh,
                                     scale=scale, interpret=True))
    live = (bias == 0).any(axis=-1)
    live = live if pairwise else live[:, None].repeat(t, 1)
    assert live.any() and not live.all()
    np.testing.assert_allclose(got[live], pallas[live], atol=TOL, rtol=TOL)


def _mha_bf16x6(q, k, v, bias, scale, passes=BF16X6_PASSES):
    """The per-(batch, head) attention's f32 arithmetic (csrc/attention.cu,
    namespaces x6 and wide): s = (q·kᵀ in six products) · scale + bias,
    p = softmax(s) in f32, context = p·v in six products."""
    s = matmul_bf16x6(q, k.transpose(-1, -2), passes)
    s = s * torch.tensor(scale, dtype=torch.float32)
    s = s + (bias[:, None] if bias.dim() == 3 else bias[:, None, None, :])
    return matmul_bf16x6(torch.softmax(s, dim=-1), v, passes)


def _mha_inputs(rng, b, h, t, dh, pairwise, qk_std=1.0):
    """q, k, v [B, H, T, dh] and a bias with fully padded rows (as
    ``_attention_inputs``: pairwise, row 0's last quarter of queries sees
    no key; key-side, row 1 all padding)."""
    q, k, v = (rng.standard_normal((b, h, t, dh)).astype(np.float32)
               for _ in range(3))
    _, bias = _attention_inputs(rng, b, t, 1, 1, pairwise)
    return q * np.float32(qk_std), k * np.float32(qk_std), v, bias


def _mha_both(q, k, v, bias, scale, passes=BF16X6_PASSES):
    """(``_mha_bf16x6`` as a tensor, ``_mha_jnp`` as an array)"""
    return (_mha_bf16x6(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                        scale, passes),
            np.asarray(_mha_jnp(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                scale)))


@pytest.mark.parametrize("t", [37, 100, 512])
@pytest.mark.parametrize("pairwise", [False, True],
                         ids=["key_side", "pairwise"])
@pytest.mark.parametrize("dh", [1, 13, 26, 64, 128, 136, 256])
def test_mha_bf16x6_matches_mha_jnp(dh, pairwise, t):
    """(e) Both dots in six products against bert_tpu's f32 per-(batch,
    head) attention, fully padded rows included."""
    rng = np.random.default_rng(1000 + 10 * dh + t + pairwise)
    q, k, v, bias = _mha_inputs(rng, 2, 2, t, dh, pairwise)
    got, ref = _mha_both(q, k, v, bias, 1.0 / dh ** 0.5)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dh", [26, 136])
def test_mha_bf16x6_matches_pallas_interpret(dh):
    """(e) Key-side, against the Pallas ``_mha_kernel`` in interpret mode
    (it has no pairwise form), the fully padded batch row included."""
    rng = np.random.default_rng(2000 + dh)
    q, k, v, bias = _mha_inputs(rng, 2, 2, 100, dh, False)
    scale = 1.0 / dh ** 0.5
    got = _mha_bf16x6(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                      scale).numpy()
    ref = np.asarray(_mha_pallas(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                 scale, interpret=True))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", ["q4_0", "q4_1", "attention"])
def test_three_products_miss_the_tolerance(case):
    """(d) bf16x3 (hi·hi, hi·mid, mid·hi: the three largest passes) is not
    f32-grade: at K = 1,536 it misses (b)'s tolerance by more than twice,
    and the per-(batch, head) attention at d_head 26, T 512 with q and k
    of std 2 misses (e)'s, where the six products pass the same inputs."""
    if case == "attention":
        rng = np.random.default_rng(3000)
        q, k, v, bias = _mha_inputs(rng, 2, 2, 512, 26, False, qk_std=2.0)
        six, three = (_worst(*_mha_both(q, k, v, bias, 26 ** -0.5, p))
                      for p in (BF16X6_PASSES, BF16X6_PASSES[3:]))
    else:
        x, w, ref = _q4_case({"q4_0": 2, "q4_1": 3}[case], 1536, 37, 201)
        six, three = (_worst(matmul_bf16x6(x, w, passes=p), ref)
                      for p in (BF16X6_PASSES, BF16X6_PASSES[3:]))
    assert six <= 1.0
    assert three > 2.0

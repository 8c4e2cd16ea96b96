"""The port's per-(batch, head) attention on the CPU against bert_tpu's.

``multi_head_attention`` on CPU tensors runs its plain version, which is
held against both JAX versions on the same numpy inputs: ``_mha_jnp``, what
the JAX model runs on a CPU, and the Pallas ``_mha_kernel`` run in
interpret mode, as tests/test_kernels.py runs it. Shapes include d_head 26
(rubert-tiny2), 80, and 137, 160 and 256 (the kernel's wide-head instance,
an odd one among them), which only this route takes. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py; CUDA has no
interpret mode.

Tolerances: f32 against ``_mha_jnp`` 1e-6 (the same f32 arithmetic, summed
in another order), at head dims above 160 1e-6·√(d_head / 160) (each score
sums d_head products, and two f32 sums of n terms in different orders
drift apart as √n: d_head 256 measured 1.01e-6); f32 against interpret mode atol 1e-5, rtol 1e-4, as
tests/test_kernels.py:74 holds the Pallas kernel to ``_mha_jnp``; bf16
2e-2 against both (p and the output each round once to bf16, 4e-3 for an
O(1) value, and the frameworks round the f32 softmax differently before
that).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bert_tpu.ops.attention import _mha_jnp, _mha_pallas
from bert_tpu_torch.ops.attention import (_check_alignment, _mha_plain,
                                          multi_head_attention)

# One intra-op thread: the suite runs several test files at once, and
# torch's default pool (one thread per core, in every worker) starves
# the timing-sensitive tests running beside these.
torch.set_num_threads(1)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL_JNP = {"f32": (1e-6, 1e-6), "bf16": (2e-2, 2e-2)}
TOL_INTERPRET = {"f32": (1e-5, 1e-4), "bf16": (2e-2, 2e-2)}
# d_head 32, 26 (rubert-tiny2), 80 (the kernel's DH = 128 instance), and
# 160, 256 and 137 (its instance for head dims above 128: three and four
# 64-lane chunks, and an odd head dim, which bf16 copies element-wise)
SHAPES = [(2, 4, 64, 32), (2, 3, 96, 26), (2, 2, 40, 80), (2, 2, 40, 160),
          (2, 2, 40, 256), (2, 2, 40, 137)]


def _tol_jnp(dname, dh):
    """TOL_JNP, the f32 one grown as √(d_head / 160) above 160."""
    atol, rtol = TOL_JNP[dname]
    if dname == "f32" and dh > 160:
        atol = rtol = atol * (dh / 160) ** 0.5
    return atol, rtol


def _inputs(rng, b, h, t, dh, pairwise=False):
    q, k, v = (rng.standard_normal((b, h, t, dh)).astype(np.float32)
               for _ in range(3))
    if pairwise:  # three packed segments per row, then padding
        seg = np.minimum(np.arange(t) * 3 // (t - 4) + 1, 3)
        seg[-4:] = 0
        seg = seg[None].repeat(b, 0)
        same = seg[:, :, None] == seg[:, None, :]
        bias = np.where(same & (seg > 0)[:, None, :], 0.0, -1e9)
    else:  # key-side padding
        mask = (rng.random((b, t)) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
        bias = (mask - 1.0) * 1e9
    return q, k, v, bias.astype(np.float32)


def _both(arrays, dname):
    td, jd = DTYPES[dname]
    qkv_t = [torch.from_numpy(a).to(td) for a in arrays[:3]]
    qkv_j = [jnp.asarray(a).astype(jd) for a in arrays[:3]]
    return (qkv_t + [torch.from_numpy(arrays[3])],
            qkv_j + [jnp.asarray(arrays[3])])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["dh32", "dh26", "dh80", "dh160", "dh256",
                              "dh137"])
def test_mha_matches_jnp_and_interpret_mode(shape, dname):
    rng = np.random.default_rng(sum(shape))
    (qt, kt, vt, bt), (qj, kj, vj, bj) = _both(_inputs(rng, *shape), dname)
    scale = 1.0 / shape[-1] ** 0.5
    got = multi_head_attention(qt, kt, vt, bt, scale=scale)
    assert got.shape == shape and got.dtype == qt.dtype
    assert torch.equal(got, _mha_plain(qt, kt, vt, bt, scale))  # CPU → plain
    atol, rtol = _tol_jnp(dname, shape[-1])
    np.testing.assert_allclose(_f32(got), _f32(_mha_jnp(qj, kj, vj, bj,
                                                        scale)),
                               atol=atol, rtol=rtol)
    atol, rtol = TOL_INTERPRET[dname]
    pallas = _mha_pallas(qj, kj, vj, bj, scale, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_mha_pairwise_bias_matches_jnp(dname):
    """Packed rows' block-diagonal bias: the Pallas kernel has no such
    form (bert_tpu sends it to _mha_jnp); the port's kernel takes it."""
    rng = np.random.default_rng(50)
    arrays = _inputs(rng, 3, 2, 40, 26, pairwise=True)
    (qt, kt, vt, bt), (qj, kj, vj, bj) = _both(arrays, dname)
    got = multi_head_attention(qt, kt, vt, bt, scale=0.2)
    atol, rtol = TOL_JNP[dname]
    np.testing.assert_allclose(_f32(got), _f32(_mha_jnp(qj, kj, vj, bj, 0.2)),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("pairwise", [False, True],
                         ids=["key_side", "pairwise"])
def test_masked_keys_have_no_influence(pairwise):
    rng = np.random.default_rng(51)
    q, k, v, bias = _inputs(rng, 2, 3, 48, 26, pairwise=pairwise)
    # keys no query of the row may see, and query rows with a live key
    dead = (bias < 0).all(axis=1) if pairwise else bias < 0  # [B, T]
    live = (bias == 0).any(axis=-1) if pairwise else np.ones_like(dead)
    assert dead.any() and live.any()
    k2, v2 = k.copy(), v.copy()
    k2.transpose(0, 2, 1, 3)[dead] = 50.0  # views: writes reach k2, v2
    v2.transpose(0, 2, 1, 3)[dead] = -50.0
    out = [multi_head_attention(*(torch.from_numpy(a) for a in
                                  (q, kk, vv, bias)), scale=0.2).numpy()
           for kk, vv in ((k, v), (k2, v2))]
    np.testing.assert_allclose(out[0].transpose(0, 2, 1, 3)[live],
                               out[1].transpose(0, 2, 1, 3)[live], atol=1e-6)


def test_fully_masked_row_is_uniform():
    """NEG_INF is finite: a fully masked row averages its own row's value
    vectors, as _mha_jnp does — no -inf, no NaN."""
    rng = np.random.default_rng(52)
    q, k, v, _ = _inputs(rng, 2, 2, 16, 26)
    bias = np.zeros((2, 16), np.float32)
    bias[1] = -1e9
    out = multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               torch.from_numpy(bias), scale=0.2).numpy()
    assert np.isfinite(out).all()
    want = np.broadcast_to(v[1].mean(axis=1, keepdims=True), (2, 16, 26))
    np.testing.assert_allclose(out[1], want, atol=1e-6)


def _rn32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    near = (np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf)))
    return min(near, key=lambda c: (abs(Fraction(float(c)) - x),
                                    int(c.view(np.uint32)) & 1))


def test_reciprocal_division_is_ieee():
    """Both kernels form p = e / l as q = e·r corrected by one FMA
    residual, q + (e - q·l)·r, with r = 1/l rounded once (``div_rn`` in
    csrc/attention.cu; ``__fdiv_rn`` branches to a slow path on every zero
    numerator). Over the softmax's range, e = exp(s - m) in [exp(-80), 1]
    or 0 and l in [1, 4001], that is the IEEE quotient wherever it lies
    above 2^-100; numpy's float32 division is the reference. The FMAs run
    in float64, where a product of two float32 values is exact; where the
    last one could round twice, exact rational arithmetic decides."""
    rng = np.random.default_rng(53)
    e = np.exp(-rng.random(1_000_000) * 80).astype(np.float32)
    e[::7] = 0.0
    l = (1 + rng.random(e.size) * 4000).astype(np.float32)
    r = np.float32(1) / l
    q = (e.astype(np.float64) * r).astype(np.float32)
    res = (e.astype(np.float64) - q.astype(np.float64) * l).astype(np.float32)
    got = (q.astype(np.float64) + res.astype(np.float64) * r).astype(np.float32)
    want = e / l
    checked = want >= np.float32(2.0 ** -100)
    assert checked.sum() > 600_000
    for i in np.nonzero((got != want) & checked)[0]:
        exact = _rn32(Fraction(float(q[i]))
                      + Fraction(float(res[i])) * Fraction(float(r[i])))
        assert exact == want[i], (e[i], l[i])


# (dtype, head dim, the copy unit in bytes): f32 rows by 16 bytes where
# dh % 4 == 0, by 8 where dh is even, by 4 otherwise; bf16 by 16 where
# dh % 8 == 0, by 4 where dh is even, element by element otherwise
ALIGNMENT = [("f32", 32, 16), ("f32", 26, 8), ("f32", 13, 4),
             ("f32", 256, 16), ("f32", 137, 4), ("bf16", 32, 16),
             ("bf16", 26, 4), ("bf16", 13, 2), ("bf16", 136, 16),
             ("bf16", 130, 4)]


@pytest.mark.parametrize("dname, dh, unit", ALIGNMENT,
                         ids=[f"{d}-dh{h}" for d, h, _ in ALIGNMENT])
def test_check_alignment_follows_the_copy_unit(dname, dh, unit):
    """The wrapper raises before a launch where q, k or v is not aligned
    to its copy unit, and where the bias is not aligned to 8 (T even) or
    4 bytes; views offset by one element are what it must catch."""
    dt = DTYPES[dname][0]
    b, h, t = 1, 2, 6
    n = b * h * t * dh
    buf = torch.zeros(2 * n + 8, dtype=dt)
    ok = buf[:n].view(b, h, t, dh)
    off = buf[n + 1:2 * n + 1].view(b, h, t, dh)  # one element later
    bias = torch.zeros(b * t + 2)
    ok_bias = bias[:b * t].view(b, t)
    _check_alignment(ok, ok, ok, ok_bias)
    for args, name in (((off, ok, ok, ok_bias), "q"),
                       ((ok, off, ok, ok_bias), "k"),
                       ((ok, ok, off, ok_bias), "v")):
        if off.data_ptr() % unit:
            with pytest.raises(ValueError, match=f"{name} at .* not {unit}-"):
                _check_alignment(*args)
        else:  # an element is the unit: any view is aligned
            _check_alignment(*args)
    assert (off.data_ptr() % unit != 0) == (unit > off.element_size())
    with pytest.raises(ValueError, match="mask_bias at .* not 8-byte"):
        _check_alignment(ok, ok, ok, bias[1:1 + b * t].view(b, t))


def test_other_devices_raise_and_wide_heads_compute():
    meta = torch.zeros(1, 2, 8, 26, device="meta")
    with pytest.raises(ValueError, match="device"):
        multi_head_attention(meta, meta, meta,
                             torch.zeros(1, 8, device="meta"), scale=0.2)
    # head dims above 128 compute on the CPU, as bert_tpu's do
    rng = np.random.default_rng(54)
    q, k, v, bias = _inputs(rng, 1, 2, 8, 136)
    got = multi_head_attention(*(torch.from_numpy(a) for a in
                                 (q, k, v, bias)), scale=0.1)
    atol, rtol = TOL_JNP["f32"]
    np.testing.assert_allclose(
        got.numpy(), _f32(_mha_jnp(*(jnp.asarray(a) for a in
                                     (q, k, v, bias)), 0.1)),
        atol=atol, rtol=rtol)


if __name__ == "__main__":
    # The deltas behind the tolerances above, as ROADMAP.md section C
    # records them:  python tests/test_torch_attention.py
    for shape in SHAPES:
        for dname in DTYPES:
            rng = np.random.default_rng(sum(shape))
            (qt, kt, vt, bt), (qj, kj, vj, bj) = _both(_inputs(rng, *shape),
                                                      dname)
            scale = 1.0 / shape[-1] ** 0.5
            got = _f32(multi_head_attention(qt, kt, vt, bt, scale=scale))
            jnp_ = _f32(_mha_jnp(qj, kj, vj, bj, scale))
            pal = _f32(_mha_pallas(qj, kj, vj, bj, scale, interpret=True))
            print(f"{shape} {dname}: port vs _mha_jnp "
                  f"{np.abs(got - jnp_).max():.2e}, vs interpret mode "
                  f"{np.abs(got - pal).max():.2e}, interpret vs _mha_jnp "
                  f"{np.abs(pal - jnp_).max():.2e}")
    for dname in DTYPES:
        rng = np.random.default_rng(50)
        (qt, kt, vt, bt), (qj, kj, vj, bj) = _both(
            _inputs(rng, 3, 2, 40, 26, pairwise=True), dname)
        got = _f32(multi_head_attention(qt, kt, vt, bt, scale=0.2))
        print(f"pairwise (3, 2, 40, 26) {dname}: port vs _mha_jnp "
              f"{np.abs(got - _f32(_mha_jnp(qj, kj, vj, bj, 0.2))).max():.2e}")

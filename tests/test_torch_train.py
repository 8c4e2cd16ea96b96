"""The port's contrastive fine-tuning on the CPU against bert_tpu's.

At tests/test_checkpoint.py's config (2 layers, D = 64, 4 heads, F = 128,
a 96-token vocab) the same weights — the JAX package's params tree,
carried across with params_from_jax / train_state_from_jax — and the same
seeded numpy batches go through bert_tpu.train (use_pallas=False, its
jnp path, as its training always runs) and bert_tpu_torch.train
(use_kernels=False). Loss, gradients, three AdamW steps (fresh and
resumed with non-zero moments, mean and CLS pooling), the train-state
round trip and the fine-tune entry point (against
examples/finetune_contrastive.py) are compared with the tolerances stated
where they are used. All in f32: the packages sum in other orders, so
equal arithmetic agrees to a few f32 ulps, not bit for bit.
"""

import importlib.util
import logging
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bert_tpu import model as jmodel
from bert_tpu import train as jtrain
from bert_tpu.params import BertConfig as JConfig
from bert_tpu.params import params_from_named_tensors as j_params_from_named
from bert_tpu.params import random_named_tensors as j_random_named
from bert_tpu_torch import model as tmodel
from bert_tpu_torch import train as ttrain
from bert_tpu_torch.checkpoint import load_train_state, save_train_state
from bert_tpu_torch.params import BertConfig as TConfig
from bert_tpu_torch.params import (
    params_from_jax,
    params_to_numpy,
    train_state_from_jax,
)
from bert_tpu_torch.testing import key_bias_lanes, noise_rule

# one intra-op thread: the suite runs several test files at once
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(n_vocab=96, n_max_tokens=32, n_embd=64, n_intermediate=128,
           n_head=4, n_layer=2)
JCFG, TCFG = JConfig(**CFG), TConfig(**CFG)


@pytest.fixture(scope="module")
def jparams():
    return j_params_from_named(j_random_named(JCFG, 4), JCFG)


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def trainable(jparams):
    return tmodel.TrainableBertModel(
        params_from_jax(host(jparams), TCFG, device="cpu"), TCFG)


def pair_batch(rng, b=4, t=8, fully_padded=False):
    """{ids_a, mask_a, ids_b, mask_b}: ragged padding (ids 0 there) in
    every batch; ``fully_padded`` makes row 2 of each side all padding."""
    out = {}
    for side in ("a", "b"):
        ids = rng.integers(1, CFG["n_vocab"], (b, t)).astype(np.int32)
        mask = np.ones((b, t), np.float32)
        for i, n in enumerate(rng.integers(2, t + 1, size=b)):
            mask[i, n:] = 0.0
        if fully_padded:
            mask[2] = 0.0
        ids[mask == 0] = 0
        out[f"ids_{side}"], out[f"mask_{side}"] = ids, mask
    return out


def jax_loss(params, batch, pooling):
    """bert_tpu's loss_fn (bert_tpu/train.py:101-113) with remat off."""
    emb_a, emb_b = (jmodel.bert_forward(
        params, jnp.asarray(batch[f"ids_{s}"]), jnp.asarray(batch[f"mask_{s}"]),
        JCFG, use_pallas=False, pooling=pooling) for s in ("a", "b"))
    return jtrain.info_nce_loss(emb_a, emb_b)


def port_loss(model, batch, pooling, remat=False):
    emb_a, emb_b = (tmodel.bert_forward(
        model, torch.from_numpy(batch[f"ids_{s}"]).long(),
        torch.from_numpy(batch[f"mask_{s}"]), use_kernels=False,
        remat=remat, pooling=pooling) for s in ("a", "b"))
    return ttrain.info_nce_loss(emb_a, emb_b)


def port_grads(model):
    return {g: {k: p.grad.numpy().copy() for k, p in sub.items()}
            for g, sub in model.tree().items()}


# -- loss, decay mask ---------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.05, 1.0])
def test_info_nce_loss_matches_bert_tpu(temperature):
    """Same L2-normed f32 embeddings → same loss within 1e-6 (a few f32
    ulps of a loss near log B: the softmax sums in another order)."""
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((8, 32)).astype(np.float32) for _ in "ab")
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    want = float(jtrain.info_nce_loss(jnp.asarray(a), jnp.asarray(b),
                                      temperature))
    got = float(ttrain.info_nce_loss(torch.from_numpy(a), torch.from_numpy(b),
                                     temperature))
    assert abs(got - want) <= 1e-6, (got, want)


def test_decay_mask_matches_bert_tpu(jparams):
    """The same names decay, for the embedding and layer groups; the
    optimizer's decayed group holds exactly those parameters and the other
    group has no weight decay."""
    want = jtrain._decay_mask(host(jparams))
    model = trainable(jparams)
    assert ttrain._decay_mask(host(jparams)) == want
    assert ttrain._decay_mask(model.tree()) == want
    opt = ttrain.make_optimizer(1e-3, weight_decay=0.01).init(model)
    decayed = {id(p) for g, sub in model.tree().items()
               for k, p in sub.items() if want[g][k]}
    assert {id(p) for p in opt.param_groups[0]["params"]} == decayed
    assert opt.param_groups[0]["weight_decay"] == 0.01
    assert opt.param_groups[1]["weight_decay"] == 0.0
    assert len(opt.param_groups[1]["params"]) == \
        sum(1 for p in model.parameters()) - len(decayed)
    assert opt.defaults["betas"] == (0.9, 0.999)
    assert opt.defaults["eps"] == 1e-8


# -- gradients, remat ---------------------------------------------------------

def assert_grads_close(got, want):
    """Each leaf: max|Δ| ≤ 1e-4 · max|g_leaf| (f32 sums over the batch and
    sequence in another order)."""
    for g in want:
        for k in want[g]:
            w = np.asarray(want[g][k])
            err = float(np.abs(got[g][k] - w).max())
            assert err <= 1e-4 * float(np.abs(w).max()), (g, k, err)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_gradients_match_bert_tpu(jparams, pooling):
    """Loss (rtol 1e-5) and every leaf's gradient against
    jax.value_and_grad of bert_tpu's loss, with padding in the masks."""
    batch = pair_batch(np.random.default_rng(1))
    want_loss, want = jax.value_and_grad(jax_loss)(jparams, batch, pooling)
    model = trainable(jparams)
    loss = port_loss(model, batch, pooling)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    assert_grads_close(port_grads(model), host(want))


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_gradients_finite_with_fully_padded_rows(jparams, pooling):
    """A batch row that is all padding attends with every key at NEG_INF:
    its softmax is uniform, and no gradient carries a NaN. bert_tpu's mean
    pooling turns every gradient NaN there (sqrt's gradient at the zero
    vector); the port's is finite and agrees with bert_tpu's wherever
    bert_tpu's is (CLS pooling)."""
    batch = pair_batch(np.random.default_rng(2), fully_padded=True)
    model = trainable(jparams)
    loss = port_loss(model, batch, pooling)
    loss.backward()
    got = port_grads(model)
    assert np.isfinite(float(loss.detach()))
    assert all(np.isfinite(v).all() for sub in got.values()
               for v in sub.values())
    want_loss, want = jax.value_and_grad(jax_loss)(jparams, batch, pooling)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    if pooling == "cls":
        assert_grads_close(got, host(want))


def test_l2_norm_is_the_clamped_norm_bit_for_bit():
    """The L2 norm's clamp on |x|² (which keeps a zero row's gradient out
    of sqrt's 0/0) divides by exactly clamp(|x|, 1e-12) in f32, from
    vectors of norm 1e-20 to 1e10 and the zero vector."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((301, 16)).astype(np.float32))
    x = x * torch.logspace(-20, 10, 301)[:, None]
    x[0] = 0.0
    norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    want = x / torch.clamp(norm, min=1e-12)
    assert torch.equal(tmodel._l2(x), want)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_remat_gradients_match(jparams, pooling, monkeypatch):
    """Per-layer recomputation does not change gradients (mirrors
    tests/test_model.py::test_remat_gradients_match's tolerances), and it
    is real: with remat every layer runs again in the backward."""
    batch = pair_batch(np.random.default_rng(3))
    calls = []
    real = tmodel.encoder_layer
    monkeypatch.setattr(tmodel, "encoder_layer",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    grads = {}
    for remat in (False, True):
        calls.clear()
        model = trainable(jparams)
        port_loss(model, batch, pooling, remat=remat).backward()
        grads[remat] = port_grads(model)
        assert len(calls) == 2 * CFG["n_layer"] * (2 if remat else 1)
    for g in grads[False]:
        for k in grads[False][g]:
            np.testing.assert_allclose(grads[True][g][k], grads[False][g][k],
                                       atol=1e-6, rtol=1e-5)


# -- three AdamW steps against bert_tpu's make_train_step ---------------------

@pytest.mark.parametrize("pooling,lr,resumed", [
    ("mean", 1e-3, False), ("cls", 1e-3, False), ("mean", 2e-5, False),
    ("mean", 1e-3, True)], ids=["mean-1e-3", "cls-1e-3", "mean-2e-5",
                                "mean-1e-3-resumed"])
def test_three_steps_match_bert_tpu(jparams, pooling, lr, resumed):
    """Three make_train_step steps (remat on, f32) from
    train_state_from_jax of a bert_tpu state, against three bert_tpu
    steps on the same batches.

    Per step: loss and grad_norm rtol 1e-5; each AdamW first moment within
    1e-4 of its leaf's largest (the gradients' bound) and each second
    moment within 2e-4 of its leaf's largest (g² doubles the relative
    error); the count and step equal. Parameters within 1e-6 of bert_tpu's
    but for at most 1e-4 of a leaf whose gradient is rounding noise, and
    qkv_b's key lanes, whose gradient is zero in exact arithmetic; those
    within 2·lr·steps (bert_tpu_torch.testing.noise_rule, the rule the
    card is held to: Adam's update ≈ lr·sign(g) may then go either way).
    Elements with a zero gradient in both packages are held to 1e-6. lr
    1e-3 puts the updates far above f32 noise; "resumed" carries a state
    two bert_tpu steps in (non-zero moments, count 2)."""
    rng = np.random.default_rng(4)
    jopt = jtrain.make_optimizer(lr)
    jstep = jtrain.make_train_step(JCFG, jopt, pooling=pooling)
    js = jtrain.init_train_state(jparams, jopt)
    if resumed:
        for _ in range(2):
            js, _ = jstep(js, pair_batch(rng))
        assert float(np.abs(host(js.opt_state[0].mu)["layers"]["o_w"]).max()) > 0
    topt = ttrain.make_optimizer(lr)
    ts = train_state_from_jax(host(js.params), host(js.opt_state),
                              host(js.step), TCFG, optimizer=topt,
                              device="cpu")
    tstep = ttrain.make_train_step(TCFG, topt, pooling=pooling)
    noisy, keys = None, key_bias_lanes(TCFG)
    for s in range(1, 4):
        batch = pair_batch(rng)
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        adam = js.opt_state[0]
        mu, nu = host(adam.mu), host(adam.nu)
        tree, want = ts.params.tree(), host(js.params)
        got = params_to_numpy(ts.params)
        if noisy is None:
            noisy = {g: {k: np.zeros(v.shape, bool) for k, v in sub.items()}
                     for g, sub in want.items()}
        for g in want:
            for k in want[g]:
                st = ts.opt_state.state[tree[g][k]]
                assert int(st["step"]) == int(adam.count)
                for name, ref, tol in (("exp_avg", mu, 1e-4),
                                       ("exp_avg_sq", nu, 2e-4)):
                    r = ref[g][k]
                    err = float(np.abs(st[name].numpy() - r).max())
                    assert err <= tol * float(np.abs(r).max()), \
                        (s, g, k, name, err)
                noise_rule(got[g][k], want[g][k], st["exp_avg"].numpy(),
                           mu[g][k], noisy[g][k], lr, s, f"step {s} {g}/{k}",
                           exempt=keys if k == "qkv_b" else None)
        assert ts.step == int(js.step)


def _leaf_case(case):
    """(got, want, mu_got, mu_want, exempt) for one noise_rule case over a
    [2, 10000] leaf at lr 1e-3, one step: every element steps by lr."""
    rng = np.random.default_rng(6)
    want = rng.standard_normal((2, 10000)).astype(np.float32)
    mu = rng.standard_normal((2, 10000)).astype(np.float32)
    got, mu_got, exempt = want.copy(), mu.copy(), None
    if case == "zero gradient moved":
        mu[0, :100] = mu_got[0, :100] = 0.0
        got[0, 5] += 1e-5
    elif case in ("two flips", "three flips"):
        n = 2 if case == "two flips" else 3
        mu_got[1, :n] = -mu[1, :n]
        got[1, :n] += 1.5e-3
    elif case == "beyond 2 lr":
        mu_got[1, 0] = -mu[1, 0]
        got[1, 0] += 2.5e-3
    elif case == "exempt lanes":
        exempt = np.arange(10000) % 3 == 1
        got[:, exempt] += 1e-3
    return got, want, mu_got, mu, exempt


@pytest.mark.parametrize("case,error", [
    ("equal", None), ("zero gradient moved", "not noise"),
    ("two flips", None), ("three flips", "beyond"),
    ("beyond 2 lr", "2·lr"), ("exempt lanes", None)])
def test_noise_rule(case, error):
    """The parameter rule of the AdamW comparisons: an element whose
    gradient is zero in both runs (equal moments) is held to 1e-6; at most
    1e-4 of a leaf (2 of 20,000) may step apart where the first moments
    disagree, never by more than 2·lr a step; exempt lanes are not
    counted."""
    got, want, mu_got, mu, exempt = _leaf_case(case)
    noisy = np.zeros(want.shape, bool)
    if error:
        with pytest.raises(AssertionError, match=error):
            noise_rule(got, want, mu_got, mu, noisy, 1e-3, 1, case,
                       exempt=exempt)
        return
    r = noise_rule(got, want, mu_got, mu, noisy, 1e-3, 1, case,
                   exempt=exempt)
    assert r["beyond"] == (2 if case == "two flips" else 0)
    assert r["exempt"] == (0 if exempt is None else 2 * int(exempt.sum()))


def test_key_bias_lanes_have_no_gradient(jparams):
    """The lanes key_bias_lanes names are where bert_tpu's qkv_b gradient
    is rounding noise: softmax ignores a constant added to every key's
    score, so the key bias has no gradient in exact arithmetic."""
    _, want = jax.value_and_grad(jax_loss)(jparams, pair_batch(
        np.random.default_rng(1)), "mean")
    g = np.abs(host(want)["layers"]["qkv_b"])
    keys = key_bias_lanes(TCFG)
    assert keys.sum() == CFG["n_embd"]
    assert g[:, keys].max() <= 1e-5 * g[:, ~keys].max()
    assert (g[:, ~keys].max(axis=0) > 1e-3 * g.max()).mean() > 0.9


# -- train-state checkpoint ---------------------------------------------------

def test_train_state_round_trip_resumes_exactly(jparams, tmp_path):
    """Save after one step, load into a fresh state, step again: exactly
    two uninterrupted steps (atol 0 on the CPU); the moments and count
    come back as saved, not reset."""
    rng = np.random.default_rng(5)
    b1, b2 = pair_batch(rng), pair_batch(rng)
    opt = ttrain.make_optimizer(1e-3)
    step = ttrain.make_train_step(TCFG, opt)

    straight = ttrain.init_train_state(trainable(jparams), opt)
    for b in (b1, b2):
        straight, _ = step(straight, b)

    first = ttrain.init_train_state(trainable(jparams), opt)
    first, _ = step(first, b1)
    save_train_state(str(tmp_path / "ckpt"), first)
    target = ttrain.init_train_state(trainable(jparams), opt)
    assert not target.opt_state.state  # fresh: no moments yet
    resumed = load_train_state(str(tmp_path / "ckpt"), target)
    assert resumed.step == 1
    saved, back = first.params.tree(), resumed.params.tree()
    for g in saved:
        for k in saved[g]:
            a = first.opt_state.state[saved[g][k]]
            b = resumed.opt_state.state[back[g][k]]
            assert int(b["step"]) == 1
            assert torch.equal(a["exp_avg"], b["exp_avg"])
            assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
            assert torch.equal(saved[g][k], back[g][k])
    resumed, _ = step(resumed, b2)
    assert resumed.step == 2
    want, got = params_to_numpy(straight.params), params_to_numpy(
        resumed.params)
    for g in want:
        for k in want[g]:
            np.testing.assert_array_equal(got[g][k], want[g][k])


def test_load_train_state_refuses_other_formats(jparams, tmp_path):
    """A directory without the port's train_state.pt (an orbax directory
    of bert_tpu's, say) raises and names the port's format."""
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "checkpoint").write_bytes(b"\0")
    target = ttrain.init_train_state(trainable(jparams),
                                     ttrain.make_optimizer())
    with pytest.raises(FileNotFoundError, match="orbax"):
        load_train_state(str(tmp_path / "orbax"), target)


# -- kernels and devices ------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, None])
def test_train_step_refuses_kernels(use_kernels):
    """The kernels have no backward: make_train_step raises rather than
    fall back, for True and for the default-routing None alike."""
    with pytest.raises(ValueError, match="no backward"):
        ttrain.make_train_step(TCFG, ttrain.make_optimizer(),
                               use_kernels=use_kernels)


def test_forward_refuses_kernels_on_cpu(jparams):
    ids = torch.ones((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        tmodel.bert_forward(trainable(jparams), ids, torch.ones((2, 8)),
                            use_kernels=True)


def test_trainable_model_refuses_quantized_weights():
    tree = j_params_from_named(j_random_named(JCFG, 4), JCFG,
                               quantize_ftype=2)
    state = params_from_jax(host(tree), TCFG, device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        tmodel.TrainableBertModel(state, TCFG)


# -- the fine-tune entry point ------------------------------------------------

FT_ARGS = ["--steps", "8", "--batch", "8", "--seq", "32", "--lr", "1e-3"]
FT_CFG = JConfig(n_vocab=30522, n_max_tokens=64, n_embd=64,
                 n_intermediate=128, n_head=4, n_layer=2)


def _ggml(path, ftype):
    from bert_tpu.formats import GgmlHParams, write_ggml
    from fixture_vocab import build_fixture_tokens

    c = FT_CFG
    hp = GgmlHParams(c.n_vocab, c.n_max_tokens, c.n_embd, c.n_intermediate,
                     c.n_head, c.n_layer, ftype=ftype)
    write_ggml(path, hp, build_fixture_tokens(), j_random_named(c, 11))
    return path


@pytest.fixture(scope="module")
def dense_model(tmp_path_factory):
    """tests/test_finetune_example.py's dense f32 ggml file."""
    return _ggml(str(tmp_path_factory.mktemp("ft") / "dense-f32.bin"), 0)


def _step_losses(text):
    return [float(x) for x in re.findall(r"^step +\d+  loss (\S+)", text,
                                         re.M)]


@pytest.fixture(scope="module")
def port_run(dense_model, tmp_path_factory):
    """finetune.main on the CPU: its result and its log."""
    import contextlib
    import io

    from bert_tpu_torch import finetune

    out = str(tmp_path_factory.mktemp("ft_port") / "tuned.npz")
    buf = io.StringIO()
    logging.disable(logging.WARNING)  # fixture vocab: unknown-token spam
    try:
        with contextlib.redirect_stdout(buf):
            r = finetune.main(["-m", dense_model, "--device", "cpu",
                               *FT_ARGS, "--out", out])
    finally:
        logging.disable(logging.NOTSET)
    return r, buf.getvalue()


def test_finetune_then_serve(port_run):
    """The loss falls, and the .npz serves through BertTorch on the CPU
    with unit norms."""
    from bert_tpu_torch import BertTorch

    r, _ = port_run
    assert r["last_loss"] < r["first_loss"], r
    assert len(r["losses"]) == 8 and np.isfinite(r["grad_norms"]).all()
    emb = BertTorch.from_file(r["out"], device="cpu").encode_batch(
        ["the store", "don't go anywhere"])
    assert emb.shape == (2, 64)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-4)


def test_finetune_npz_serves_in_bert_tpu(port_run):
    """The format is shared: BertTPU serves the port's .npz and embeds
    within 1e-5 of BertTorch (the f32 bound of the port's engine tests)."""
    from bert_tpu import BertTPU
    from bert_tpu_torch import BertTorch

    texts = ["the store", "don't go anywhere", "a man is slicing onions"]
    out = port_run[0]["out"]
    want = BertTPU.from_file(out).encode_batch(texts)
    got = BertTorch.from_file(out, device="cpu").encode_batch(texts)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_finetune_matches_the_jax_example(port_run, dense_model, tmp_path,
                                          capsys):
    """Same model, data and arguments: examples/finetune_contrastive.py
    draws the same batches and its losses match the port's: the first and
    last (returned) within rtol 1e-4, and every step's as both logs print
    it, to 4 decimals, within one unit of the last (the values agree to
    ~1e-6, so they differ there only across a rounding boundary). The log
    lines are the same but for the file names and the numbers."""
    spec = importlib.util.spec_from_file_location(
        "finetune_contrastive",
        os.path.join(REPO, "examples", "finetune_contrastive.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    logging.disable(logging.WARNING)
    try:
        want = ex.main(["-m", dense_model, *FT_ARGS,
                        "--out", str(tmp_path / "jax.npz")])
    finally:
        logging.disable(logging.NOTSET)
    jax_log = capsys.readouterr().out
    r, port_log = port_run
    np.testing.assert_allclose([r["first_loss"], r["last_loss"]],
                               [want["first_loss"], want["last_loss"]],
                               rtol=1e-4)
    want_steps = _step_losses(jax_log)
    assert len(want_steps) == 8
    np.testing.assert_allclose(_step_losses(port_log), want_steps,
                               rtol=0, atol=1.0001e-4)

    def shape(log):
        return [re.sub(r"[\d.]+|\S*\.npz\S*", "#", line)
                for line in log.splitlines()]
    assert shape(port_log) == shape(jax_log)


def test_finetune_checkpoint_resumes(dense_model, tmp_path, capsys):
    """--ckpt writes the port's train state at the end and resumes from it:
    the second run starts at step 2."""
    from bert_tpu_torch import finetune

    ckpt = str(tmp_path / "ckpt")

    def run(steps):
        return finetune.main(["-m", dense_model, "--device", "cpu",
                              "--steps", str(steps), "--batch", "8", "--seq",
                              "16", "--ckpt", ckpt,
                              "--out", str(tmp_path / "t.npz")])
    logging.disable(logging.WARNING)
    try:
        run(2)
        assert os.path.isfile(os.path.join(ckpt, "train_state.pt"))
        capsys.readouterr()
        r = run(1)
    finally:
        logging.disable(logging.NOTSET)
    log = capsys.readouterr().out
    assert f"resumed from {ckpt} at step 2" in log
    assert re.search(r"^step    3  loss", log, re.M), log
    assert len(r["losses"]) == 1


def test_finetune_refuses_quantized(tmp_path):
    from bert_tpu_torch import finetune

    p = _ggml(str(tmp_path / "q4.bin"), 2)
    with pytest.raises(SystemExit, match="quantize"):
        finetune.main(["-m", p, "--device", "cpu", "--steps", "1",
                       "--out", str(tmp_path / "x.npz")])


@pytest.mark.parametrize("flag", ["--dp", "--tp"])
def test_finetune_refuses_sharding(dense_model, tmp_path, flag,
                                   monkeypatch):
    """--dp/--tp train over dp·tp ranks: launched without them (no
    torchrun environment, no BERT_TPU_COORDINATOR) it refuses rather than
    train on one (tests/test_torch_parallel_train.py runs it under
    torchrun)."""
    from bert_tpu_torch import finetune

    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "BERT_TPU_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        finetune.main(["-m", dense_model, "--device", "cpu", flag, "2",
                       "--out", str(tmp_path / "x.npz")])


def test_finetune_defaults_to_the_card(dense_model, tmp_path):
    """Without --device it trains on the card, so here, with none, it
    raises rather than fall back to the CPU."""
    from bert_tpu_torch import finetune

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune.main(["-m", dense_model, "--steps", "1",
                       "--out", str(tmp_path / "x.npz")])

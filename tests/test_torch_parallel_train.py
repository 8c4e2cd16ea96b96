"""The port's sharded fine-tuning on the CPU against bert_tpu's.

At tests/test_torch_train.py's config (2 layers, D 64, 4 heads, F 128, a
96-token vocab) the JAX package's params tree and the same seeded numpy
batches go through bert_tpu's ``make_sharded_train_step`` on a (2, 2)
mesh of conftest's virtual CPU devices and through the port's, whose ranks
are processes spawned over gloo (one spawn per world size, its cases run
in turn by testing.rank_jobs). In f32: loss and grad_norm within rtol
1e-5, parameters under ``bert_tpu_torch.testing.noise_rule`` (the rule
test_torch_train.py holds the single-device step to). Train states move
across (dp, tp): saved at (2, 2) and resumed at (1, 1) and (1, 2), saved
on one device and resumed at (2, 2), each held to the uninterrupted
single-device run, which shows that the AdamW moments were carried.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from bert_tpu import train as jtrain
from bert_tpu.params import BertConfig as JConfig
from bert_tpu.params import params_from_named_tensors as j_params_from_named
from bert_tpu.params import random_named_tensors as j_random_named
from bert_tpu.parallel.mesh import make_mesh as j_make_mesh
from bert_tpu_torch import testing
from bert_tpu_torch import train as ttrain
from bert_tpu_torch.checkpoint import (TRAIN_STATE_FILE, load_train_state,
                                       save_train_state)
from bert_tpu_torch.model import TrainableBertModel
from bert_tpu_torch.params import BertConfig as TConfig
from bert_tpu_torch.params import params_to_numpy, params_to_torch
from bert_tpu_torch.parallel.multihost import spawn_ranks
from bert_tpu_torch.testing import key_bias_lanes, noise_rule

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(n_vocab=96, n_max_tokens=32, n_embd=64, n_intermediate=128,
           n_head=4, n_layer=2)
JCFG, TCFG = JConfig(**CFG), TConfig(**CFG)
LR = 1e-3
N_STEPS = 5  # 3 sharded, then 2 more after each resume


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair_batches():
    """Five {ids_a, mask_a, ids_b, mask_b} batches of 8 pairs × 8 tokens
    with ragged padding."""
    rng = np.random.default_rng(4)
    out = []
    for _ in range(N_STEPS):
        b = {}
        for side in ("a", "b"):
            ids = rng.integers(1, CFG["n_vocab"], (8, 8)).astype(np.int32)
            mask = np.ones((8, 8), np.float32)
            for i, n in enumerate(rng.integers(2, 9, size=8)):
                mask[i, n:] = 0.0
            ids[mask == 0] = 0
            b[f"ids_{side}"], b[f"mask_{side}"] = ids, mask
        out.append(b)
    return out


@pytest.fixture(scope="module")
def jparams():
    return j_params_from_named(j_random_named(JCFG, 4), JCFG)


def _record(state, metrics):
    mu = {g: {k: state.opt_state.state[p]["exp_avg"].numpy().copy()
              for k, p in sub.items()}
          for g, sub in state.params.tree().items()}
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "step": state.step,
            "params": params_to_numpy(state.params), "mu": mu}


def _one_device(params, batches, ckpt_in=None, ckpt_out_after=None,
                ckpt_out=None):
    """The port's single-device steps (make_train_step) from ``params`` or
    the state in ``ckpt_in``; saves after ``ckpt_out_after`` steps."""
    opt = ttrain.make_optimizer(LR)
    state = ttrain.init_train_state(TrainableBertModel(
        params_to_torch(params, device="cpu"), TCFG), opt)
    if ckpt_in:
        state = load_train_state(ckpt_in, state)
    step = ttrain.make_train_step(TCFG, opt)
    out = []
    for i, b in enumerate(batches):
        state, m = step(state, b)
        out.append(_record(state, m))
        if ckpt_out and i + 1 == ckpt_out_after:
            save_train_state(ckpt_out, state)
    return out


@pytest.fixture(scope="module")
def runs(jparams, tmp_path_factory):
    """Every run the tests compare: bert_tpu's sharded steps, the port's
    uninterrupted single-device steps, and the port's sharded and resumed
    ones."""
    d = tmp_path_factory.mktemp("sharded_train")
    one_ckpt, mesh_ckpt = str(d / "one_device"), str(d / "mesh_2x2")
    params = host(jparams)
    batches = pair_batches()

    jopt = jtrain.make_optimizer(LR)
    placed, jstep = jtrain.make_sharded_train_step(
        j_make_mesh(4, tp=2), JCFG, jopt,
        jtrain.init_train_state(jparams, jopt))
    jax_steps = []
    for b in batches[:3]:
        placed, m = jstep(placed, b)
        jax_steps.append({"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "params": host(placed.params),
                          "mu": host(placed.opt_state[0].mu),
                          "count": int(placed.opt_state[0].count)})

    one = _one_device(params, batches, ckpt_out_after=3, ckpt_out=one_ckpt)
    job = lambda dp, tp, bs, **kw: ("train", dict(  # noqa: E731
        config=TCFG, params=params, dp=dp, tp=tp, lr=LR, batches=bs, **kw))
    w4 = spawn_ranks(4, testing.rank_jobs, [
        job(2, 2, batches[:3], ckpt_out=mesh_ckpt),
        job(2, 2, batches[3:], ckpt_in=one_ckpt)])
    w2 = spawn_ranks(2, testing.rank_jobs, [
        job(1, 2, batches[3:], ckpt_in=mesh_ckpt)])
    for ranks in (w4, w2):
        for other in ranks[1:]:  # every rank reports the same run
            for job_a, job_b in zip(ranks[0], other):
                for sa, sb in zip(job_a, job_b):
                    assert sa["loss"] == sb["loss"]
                    assert sa["grad_norm"] == sb["grad_norm"]
    return {"jax": jax_steps, "one": one, "mesh": w4[0][0],
            "one_to_mesh": w4[0][1], "mesh_to_1x2": w2[0][0],
            "mesh_to_one": _one_device(params, batches[3:],
                                       ckpt_in=mesh_ckpt),
            "mesh_ckpt": mesh_ckpt}


def _hold(got_steps, want_steps, first_step, what, noisy=None):
    """Loss and grad_norm within rtol 1e-5, parameters under noise_rule,
    step by step; returns the noise mask, which a run resumed from
    ``got_steps``' state carries on."""
    keys = key_bias_lanes(TCFG)
    for i, (g, w) in enumerate(zip(got_steps, want_steps)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-5)
        if noisy is None:
            noisy = {gr: {k: np.zeros(v.shape, bool) for k, v in sub.items()}
                     for gr, sub in w["params"].items()}
        for gr, sub in w["params"].items():
            for k, want in sub.items():
                noise_rule(g["params"][gr][k], want, g["mu"][gr][k],
                           w["mu"][gr][k], noisy[gr][k], LR,
                           first_step + i, f"{what} step {first_step + i} "
                           f"{gr}/{k}",
                           exempt=keys if k == "qkv_b" else None)
    return noisy


def test_sharded_steps_match_bert_tpu(runs):
    """Three make_sharded_train_step steps at (dp, tp) = (2, 2) against
    bert_tpu's on the same mesh shape; the AdamW count and the step
    follow."""
    _hold(runs["mesh"], runs["jax"], 1, "(2, 2)")
    for i, (g, w) in enumerate(zip(runs["mesh"], runs["jax"])):
        assert g["count"] == w["count"] == g["step"] == i + 1


def test_sharded_steps_match_one_device(runs):
    """The (2, 2) steps are the single-device steps: the same loss over
    the whole batch and the same gradients (summed over data, the model
    shards gathered)."""
    _hold(runs["mesh"], runs["one"][:3], 1, "(2, 2) vs one device")


def test_checkpoint_holds_the_sharded_state_whole(runs):
    """The (2, 2) state saved after step 3 holds the whole parameters and
    moments, bit for bit the gathered run's, count 3, step 3."""
    saved = torch.load(os.path.join(runs["mesh_ckpt"], TRAIN_STATE_FILE),
                       weights_only=True)
    last = runs["mesh"][-1]
    assert saved["step"] == saved["count"] == 3
    for gr, sub in last["params"].items():
        for k, v in sub.items():
            np.testing.assert_array_equal(saved["params"][f"{gr}/{k}"], v)
            np.testing.assert_array_equal(saved["mu"][f"{gr}/{k}"],
                                          last["mu"][gr][k])
    assert np.abs(saved["mu"]["layers/o_w"].numpy()).max() > 0


@pytest.mark.parametrize("run", ["mesh_to_one", "mesh_to_1x2",
                                 "one_to_mesh"])
def test_state_resumes_across_meshes(runs, run):
    """A state saved at (2, 2) resumed on one device and at (1, 2), and a
    single-device state resumed at (2, 2): steps 4 and 5 are the
    uninterrupted run's. Reset moments would take Adam's bias-corrected
    first step again (an update of lr·sign(g) everywhere), far outside
    the rule."""
    assert [s["step"] for s in runs[run]] == [4, 5]
    # elements whose gradient was noise in steps 1-3 of the run that wrote
    # the state stay noise (none where that run is the reference itself)
    noisy = (None if run == "one_to_mesh" else
             _hold(runs["mesh"], runs["one"][:3], 1, "(2, 2) vs one device"))
    _hold(runs[run], runs["one"][3:], 4, run, noisy)


class _FakeMesh:
    mesh_dim_names = ("x", "y")
    device_type = "cpu"


def test_sharded_step_needs_a_data_axis(jparams):
    """A mesh without bert_tpu's axis names: bert_tpu's message."""
    jopt = jtrain.make_optimizer(LR)
    with pytest.raises(ValueError) as want:
        jtrain.make_sharded_train_step(
            j_make_mesh(4, tp=2, axis_names=("x", "y")), JCFG, jopt,
            jtrain.init_train_state(jparams, jopt))
    topt = ttrain.make_optimizer(LR)
    state = ttrain.init_train_state(TrainableBertModel(
        params_to_torch(host(jparams), device="cpu"), TCFG), topt)
    with pytest.raises(ValueError) as got:
        ttrain.make_sharded_train_step(_FakeMesh(), TCFG, topt, state)
    assert str(got.value) == str(want.value)


# -- the entry point under torchrun ------------------------------------------

def _ggml(path):
    from bert_tpu_torch.formats import GgmlHParams, write_ggml
    from bert_tpu_torch.params import random_named_tensors
    from fixture_vocab import build_fixture_tokens

    c = TConfig(n_vocab=30522, n_max_tokens=64, n_embd=64,
                n_intermediate=128, n_head=4, n_layer=2)
    hp = GgmlHParams(c.n_vocab, c.n_max_tokens, c.n_embd, c.n_intermediate,
                     c.n_head, c.n_layer, ftype=0)
    write_ggml(path, hp, build_fixture_tokens(), random_named_tensors(c, 11))
    return path


def _losses(text):
    return [float(x) for x in re.findall(r"^step +\d+  loss (\S+)", text,
                                         re.M)]


def test_finetune_under_torchrun_matches_one_device(tmp_path):
    """``torchrun --nproc-per-node 4 -m bert_tpu_torch.finetune --dp 2
    --tp 2 --device cpu``: rank 0 alone logs, names the mesh as
    examples/finetune_contrastive.py does and writes the .npz; its losses
    and weights are the single-device run's (losses as logged, to 4
    decimals; weights within 2·lr·steps, noise_rule's bound without
    moments)."""
    import socket

    from bert_tpu_torch import finetune

    model = _ggml(str(tmp_path / "dense.bin"))
    args = ["-m", model, "--device", "cpu", "--steps", "3", "--batch", "8",
            "--seq", "32", "--lr", str(LR)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         "--nproc-per-node=4", "--master-addr=127.0.0.1",
         f"--master-port={port}", "-m", "bert_tpu_torch.finetune", *args,
         "--dp", "2", "--tp", "2", "--out", str(tmp_path / "mesh.npz")],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO,
                                    OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("sharded step over mesh (data=2, model=2)") == 1
    assert r.stdout.count("positive pairs") == 1, r.stdout
    one = finetune.main(args + ["--out", str(tmp_path / "one.npz")])
    np.testing.assert_allclose(_losses(r.stdout), one["losses"], atol=1e-4)
    with np.load(tmp_path / "mesh.npz") as a, \
            np.load(tmp_path / "one.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k.startswith("__"):
                assert str(a[k]) == str(b[k]), k
            else:
                np.testing.assert_allclose(a[k], b[k], atol=2 * LR * 3,
                                           err_msg=k)

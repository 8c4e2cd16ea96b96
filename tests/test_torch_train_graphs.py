"""The captured train step (bert_tpu_torch/_graphs.py ``TrainProgram``,
``train.make_train_step(jit=True)``) on the CPU.

bert_tpu jits its train step: one compiled program per batch shape
(bert_tpu/train.py:128). The port keeps one ``TrainProgram`` per (batch
shape, model, optimizer), a CUDA graph on the card. On the CPU nothing is
captured, but the same staging and keying run and the step runs eagerly,
so these tests hold what the card runs, at tests/test_torch_train.py's
config (2 layers, D = 64, 4 heads) with batches of 4 pairs of 16 tokens:

(a) three ``jit=True`` steps against bert_tpu's jitted ``make_train_step``
    under ``testing.noise_rule`` (mean and CLS, fresh and resumed two
    steps in), with the tolerances of test_torch_train.py;
(b) ``jit=True`` against ``jit=False``, bit for bit: loss, grad_norm,
    parameters and both moments, and no kernel launch counted;
(c) keying: another batch shape gets its own program, the same shape
    reuses it, and another model or optimizer never steps the first
    state's tensors;
(d) the card's order of events, with fake CUDA objects: step 1 eager on a
    side stream, gradients set to None then one capture at step 2, a
    replay every later step with no gradient set to None between, the
    program's gradients back on the parameters after each replay, the
    launch counters at 0, and a program made anew once the optimizer's
    tensors are not the captured ones;
(e) ``place_adam_state``, ``load_train_state`` and ``train_state_from_jax``
    put AdamW's step count where the optimizer expects it, and a resumed
    ``jit=True`` step matches a resumed ``jit=False`` one bit for bit;
(f) a step's metrics are tensors of their own, untouched by the next.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from bert_tpu import train as jtrain
from bert_tpu_torch import _graphs
from bert_tpu_torch import model as tmodel
from bert_tpu_torch import train as ttrain
from bert_tpu_torch.checkpoint import load_train_state, save_train_state
from bert_tpu_torch.ops.common import COUNTERS
from bert_tpu_torch.params import params_to_numpy, train_state_from_jax
from bert_tpu_torch.testing import key_bias_lanes, noise_rule
from test_torch_train import (JCFG, TCFG, host,  # noqa: F401 (fixture)
                              jparams, pair_batch)

torch.set_num_threads(1)

B, T = 4, 16


def batches(seed, n, b=B, t=T):
    rng = np.random.default_rng(seed)
    return [pair_batch(rng, b=b, t=t) for _ in range(n)]


def trainable(jparams):
    from bert_tpu_torch.params import params_from_jax

    return tmodel.TrainableBertModel(
        params_from_jax(host(jparams), TCFG, device="cpu"), TCFG)


def snapshot(state):
    """Parameters, both moments and the step counts, as host copies."""
    tree = state.params.tree()
    out = {"params": params_to_numpy(state.params)}
    for name in ("exp_avg", "exp_avg_sq", "step"):
        out[name] = {g: {k: state.opt_state.state[p][name].cpu().numpy()
                         .copy() for k, p in sub.items()}
                     for g, sub in tree.items()}
    return out


def assert_equal_trees(got, want):
    for name in want:
        for g in want[name]:
            for k in want[name][g]:
                np.testing.assert_array_equal(got[name][g][k],
                                              want[name][g][k],
                                              err_msg=f"{name} {g}/{k}")


def counts():
    return [c.launches for c in COUNTERS]


# (a) -------------------------------------------------------------------------

@pytest.mark.parametrize("pooling,resumed", [
    ("mean", False), ("cls", False), ("mean", True), ("cls", True)],
    ids=["mean", "cls", "mean-resumed", "cls-resumed"])
def test_captured_steps_match_bert_tpus_jitted_step(jparams, pooling,
                                                    resumed):
    """Three make_train_step(jit=True) steps from train_state_from_jax of
    a bert_tpu state, against bert_tpu's jitted step on the same batches
    (lr 1e-3): loss and grad_norm rtol 1e-5; each first moment within 1e-4
    and each second moment within 2e-4 of its leaf's largest; parameters
    under noise_rule (qkv_b's key lanes exempt); count and step equal.
    "resumed" starts two bert_tpu steps in (non-zero moments, count 2)."""
    lr = 1e-3
    data = batches(8, 5)
    jopt = jtrain.make_optimizer(lr)
    jstep = jtrain.make_train_step(JCFG, jopt, pooling=pooling)
    js = jtrain.init_train_state(jparams, jopt)
    if resumed:
        for b in data[3:]:
            js, _ = jstep(js, b)
    topt = ttrain.make_optimizer(lr)
    ts = train_state_from_jax(host(js.params), host(js.opt_state),
                              host(js.step), TCFG, optimizer=topt,
                              device="cpu")
    tstep = ttrain.make_train_step(TCFG, topt, pooling=pooling)
    noisy, keys = None, key_bias_lanes(TCFG)
    for s, b in enumerate(data[:3], 1):
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        adam = js.opt_state[0]
        mu, nu, want = host(adam.mu), host(adam.nu), host(js.params)
        got, tree = params_to_numpy(ts.params), ts.params.tree()
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
    assert len(tstep.programs[torch.device("cpu")].table) == 1


# (b) -------------------------------------------------------------------------

@pytest.mark.parametrize("pooling,remat,dtype", [
    ("mean", True, torch.float32), ("cls", True, torch.float32),
    ("mean", False, torch.float32), ("mean", True, torch.bfloat16)],
    ids=["mean", "cls", "no-remat", "bf16"])
def test_captured_step_is_the_eager_step_bit_for_bit(jparams, pooling, remat,
                                                     dtype):
    """Four steps each way from the same weights and batches: every
    step's loss and grad_norm, and after it every parameter, both moments
    and the step counts, bit for bit; the kernels' launch counters do not
    move (training runs the plain versions)."""
    data = batches(9, 4)
    runs = {}
    before = counts()
    for jit in (True, False):
        opt = ttrain.make_optimizer(1e-3)
        state = ttrain.init_train_state(trainable(jparams), opt)
        step = ttrain.make_train_step(TCFG, opt, pooling=pooling,
                                      remat=remat, compute_dtype=dtype,
                                      jit=jit)
        rows = []
        for b in data:
            state, m = step(state, b)
            rows.append((m["loss"], m["grad_norm"], snapshot(state)))
        runs[jit] = rows
    assert counts() == before
    for (l1, g1, s1), (l0, g0, s0) in zip(runs[True], runs[False]):
        assert torch.equal(l1, l0) and torch.equal(g1, g0)
        assert_equal_trees(s1, s0)


def test_eager_step_is_the_old_step(jparams):
    """jit=False takes no program: each call converts the batch and runs
    the ops from Python, and the step function has no program table."""
    step = ttrain.make_train_step(TCFG, ttrain.make_optimizer(), jit=False)
    assert not hasattr(step, "programs")
    state = ttrain.init_train_state(trainable(jparams),
                                    ttrain.make_optimizer())
    state, m = step(state, {k: torch.from_numpy(v)
                            for k, v in batches(1, 1)[0].items()})
    assert state.step == 1 and np.isfinite(float(m["loss"]))


# (c) -------------------------------------------------------------------------

def test_each_batch_shape_has_its_own_program(jparams):
    """Two batch shapes, interleaved: two programs, each made once and
    called at its shape's steps; the steps are those of the eager step on
    the same batches, bit for bit."""
    small = batches(10, 2, b=2, t=8)
    big = batches(11, 3)
    order = [big[0], small[0], big[1], big[2], small[1]]
    opt = ttrain.make_optimizer(1e-3)
    state = ttrain.init_train_state(trainable(jparams), opt)
    step = ttrain.make_train_step(TCFG, opt)
    made = []
    for b in order:
        state, _ = step(state, b)
        progs = step.programs[torch.device("cpu")].table
        made.append(progs[(b["ids_a"].shape, b["ids_b"].shape,
                           id(state.params), id(state.opt_state))])
    assert len(progs) == 2
    assert made[0] is made[2] is made[3] and made[1] is made[4]
    assert made[0] is not made[1]
    assert (made[0].steps, made[1].steps) == (3, 2)
    assert tuple(made[1].inputs["ids_a"].shape) == (2, 8)
    assert made[1].inputs["ids_a"].dtype == torch.int64
    assert made[1].inputs["mask_a"].dtype == torch.float32

    eopt = ttrain.make_optimizer(1e-3)
    eager = ttrain.init_train_state(trainable(jparams), eopt)
    estep = ttrain.make_train_step(TCFG, eopt, jit=False)
    for b in order:
        eager, _ = estep(eager, b)
    assert_equal_trees(snapshot(state), snapshot(eager))


@pytest.mark.parametrize("other", ["model", "optimizer"])
def test_another_state_never_steps_the_first_ones_tensors(jparams, other):
    """One step function, two states (another model and its optimizer, or
    the same model under another optimizer): each gets a program of its
    own, bound to its own tensors. The first state's tensors do not move
    while the second trains, and its next step is the one it would have
    taken alone."""
    data = batches(12, 3)
    spec = ttrain.make_optimizer(1e-3)
    step = ttrain.make_train_step(TCFG, spec)
    first = ttrain.init_train_state(trainable(jparams), spec)
    first, _ = step(first, data[0])
    kept = snapshot(first)
    model = trainable(jparams) if other == "model" else first.params
    second = ttrain.TrainState(params=model, opt_state=spec.init(model),
                               step=0)
    if other == "optimizer":
        # the same model's parameters: keep the first state's as they are
        with torch.no_grad():
            saved = [p.clone() for p in model.parameters()]
    for b in data[:2]:
        second, _ = step(second, b)
    progs = list(step.programs[torch.device("cpu")].table.values())
    assert len(progs) == 2
    assert progs[0].opt is first.opt_state and progs[1].opt is second.opt_state
    assert progs[1].model is second.params
    if other == "model":
        assert_equal_trees(snapshot(first), kept)
    else:
        with torch.no_grad():
            for p, s in zip(model.parameters(), saved):
                p.copy_(s)
    first, _ = step(first, data[2])

    aopt = ttrain.make_optimizer(1e-3)
    alone = ttrain.init_train_state(trainable(jparams), aopt)
    astep = ttrain.make_train_step(TCFG, aopt)
    for b in (data[0], data[2]):
        alone, _ = astep(alone, b)
    assert_equal_trees(snapshot(first), snapshot(alone))


def test_a_state_built_by_another_spec_raises(jparams):
    opt = ttrain.make_optimizer(1e-3)
    state = ttrain.init_train_state(trainable(jparams), opt)
    step = ttrain.make_train_step(TCFG, ttrain.make_optimizer(2e-5))
    with pytest.raises(ValueError, match="not built by"):
        step(state, batches(13, 1)[0])
    assert not step.programs


# (d) -------------------------------------------------------------------------

class _FakeGraph:
    """Records the captured step and replays it without running Python's
    counting, as a graph replays its kernels."""

    def __init__(self):
        self.replay_fn = None

    def replay(self):
        self.replay_fn()


def _fake_cuda(monkeypatch, events):
    where = {"stream": "current"}

    class Stream:
        def wait_stream(self, other):
            events.append(("wait",))

    @contextlib.contextmanager
    def stream(s):
        where["stream"] = "side"
        yield
        where["stream"] = "current"

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local" and pool == "pool"
        where["graph"] = g
        yield
        where.pop("graph")
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(torch.cuda, "stream", stream)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    return where


def test_card_order_of_events(jparams, monkeypatch):
    """On the card's path (fake CUDA objects): step 1 sets the gradients
    to None and runs eagerly on a side stream; step 2 sets them to None
    once and captures (the capture runs nothing on the card; here the
    fake records the step), then replays; steps 3 and 4 replay, and no
    gradient is set to None between replays. After each replay every
    parameter's .grad is the gradient the capture allocated, though
    something set it to None in between; the launch counters stay at 0.
    Once the optimizer's moments are placed anew the program is no longer
    current and the table makes another."""
    events = []
    where = _fake_cuda(monkeypatch, events)
    model = trainable(jparams)
    opt = ttrain.make_optimizer(1e-3).init(model)
    zeros = {g: {k: np.zeros(tuple(p.shape), np.float32)
                 for k, p in sub.items()} for g, sub in model.tree().items()}
    ttrain.place_adam_state(opt, model, zeros, zeros, 0)
    real_zero = opt.zero_grad

    def zero_grad(set_to_none=True):
        events.append(("zero_grad", set_to_none))
        real_zero(set_to_none=set_to_none)
    opt.zero_grad = zero_grad
    params = list(model.parameters())
    outputs = []

    def step(ids_a, mask_a, ids_b, mask_b, replaying=False):
        if replaying:  # the captured work, on the static tensors
            events.append(("replay",))
            outputs[0].copy_(ids_a.sum())
            return None
        g = where.get("graph")
        if g is not None:
            g.replay_fn = functools.partial(step, ids_a, mask_a, ids_b,
                                            mask_b, replaying=True)
        events.append(("step", "capture" if g is not None
                       else where["stream"]))
        for p in params:  # what the backward allocates
            p.grad = torch.zeros_like(p)
        outputs[:] = [ids_a.sum(), mask_a.sum()]
        return tuple(outputs)

    table = _graphs.Programs(torch.device("cpu"))
    table.pool = "pool"
    data = batches(14, 4)
    arrays = [ttrain._host_batch(b) for b in data]
    key = ("key",)
    make = functools.partial(_graphs.TrainProgram, model=model, opt=opt)
    prog = table.get(key, step, arrays[0], make)
    prog.device = torch.device("cuda")  # take the card's path
    before = counts()
    log = []
    for i, a in enumerate(arrays):
        events.clear()
        assert table.get(key, step, a, make) is prog
        out = prog(**a)
        log.append(list(events))
        assert float(out[0]) == float(a["ids_a"].sum())
        if i >= 1:
            assert all(p.grad is g for p, g in zip(params, prog.grads))
        if i == 2:
            for p in params:  # another program's eager step, say
                p.grad = None
    assert log[0] == [("zero_grad", True), ("wait",), ("step", "side"),
                      ("wait",)]
    assert log[1] == [("zero_grad", True), ("step", "capture"), ("replay",)]
    assert log[2] == log[3] == [("replay",)]
    assert prog.steps == 4 and prog.launches == [0] * len(before)
    assert counts() == before
    assert len(prog.bound) == 4 * len(params) and prog.current()

    ttrain.place_adam_state(opt, model, zeros, zeros, 4)  # a resume
    assert not prog.current()
    fresh = table.get(key, step, arrays[0], make)
    assert fresh is not prog and fresh.graph is None and fresh.steps == 0


def test_capture_failure_raises(jparams, monkeypatch):
    """A capture that fails raises: the step does not go eager."""
    _fake_cuda(monkeypatch, [])

    @contextlib.contextmanager
    def refused(g, pool=None, capture_error_mode="global"):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
        yield
    monkeypatch.setattr(torch.cuda, "graph", refused)
    model = trainable(jparams)
    opt = ttrain.make_optimizer(1e-3).init(model)
    calls = []

    def step(**kw):
        calls.append(1)
        return torch.zeros(()), torch.zeros(())
    a = ttrain._host_batch(batches(15, 1)[0])
    prog = _graphs.TrainProgram(
        step, {k: torch.tensor(v) for k, v in a.items()}, "pool",
        model=model, opt=opt)
    prog.device = torch.device("cuda")
    prog(**a)
    with pytest.raises(RuntimeError, match="capturing"):
        prog(**a)
    assert calls == [1] and prog.graph is None and prog.steps == 1


# (e) -------------------------------------------------------------------------

def _steps_devices(opt):
    return {p: opt.state[p]["step"].device.type
            for g in opt.param_groups for p in g["params"]}


def test_place_adam_state_puts_step_where_the_optimizer_wants_it(jparams):
    """A capturable group's step counts go to the parameter's device (the
    meta device here, standing in for the card), another group's to the
    CPU; the moments go to the parameter's device either way."""
    model = trainable(jparams).to("meta")
    tree = model.tree()
    names = [(g, k) for g, sub in tree.items() for k in sub]
    half = len(names) // 2
    opt = torch.optim.AdamW(
        [{"params": [tree[g][k] for g, k in names[:half]],
          "capturable": True},
         {"params": [tree[g][k] for g, k in names[half:]]}])
    zeros = {g: {k: np.zeros(tuple(p.shape), np.float32)
                 for k, p in sub.items()} for g, sub in tree.items()}
    ttrain.place_adam_state(opt, model, zeros, zeros, 2)
    for i, (g, k) in enumerate(names):
        st = opt.state[tree[g][k]]
        assert st["step"].device.type == ("meta" if i < half else "cpu")
        assert st["exp_avg"].device.type == "meta"
        assert st["exp_avg_sq"].device.type == "meta"


def test_cpu_optimizer_is_not_capturable_and_resumes_on_the_cpu(jparams,
                                                                tmp_path):
    """On the CPU the spec builds a non-capturable optimizer, and every
    way into a state (a step, load_train_state, train_state_from_jax)
    leaves its step counts on the CPU."""
    opt_spec = ttrain.make_optimizer(1e-3)
    state = ttrain.init_train_state(trainable(jparams), opt_spec)
    assert not any(g["capturable"] for g in state.opt_state.param_groups)
    step = ttrain.make_train_step(TCFG, opt_spec)
    state, _ = step(state, batches(16, 1)[0])
    assert set(_steps_devices(state.opt_state).values()) == {"cpu"}
    save_train_state(str(tmp_path / "ckpt"), state)
    loaded = load_train_state(str(tmp_path / "ckpt"), ttrain.init_train_state(
        trainable(jparams), opt_spec))
    assert set(_steps_devices(loaded.opt_state).values()) == {"cpu"}
    jopt = jtrain.make_optimizer(1e-3)
    js = jtrain.init_train_state(jparams, jopt)
    carried = train_state_from_jax(host(js.params), host(js.opt_state),
                                   host(js.step), TCFG, optimizer=opt_spec,
                                   device="cpu")
    assert set(_steps_devices(carried.opt_state).values()) == {"cpu"}


@pytest.mark.parametrize("how", ["fresh target", "same state"])
def test_resumed_captured_step_matches_resumed_eager_step(jparams, tmp_path,
                                                          how):
    """Two steps, save, load, two more: jit=True and jit=False bit for bit
    at every point. "same state" loads into the state that already took
    the steps (its program made before the load), "fresh target" into a
    new one."""
    data = batches(17, 4)
    ends = {}
    for jit in (True, False):
        spec = ttrain.make_optimizer(1e-3)
        step = ttrain.make_train_step(TCFG, spec, jit=jit)
        state = ttrain.init_train_state(trainable(jparams), spec)
        for b in data[:2]:
            state, _ = step(state, b)
        ckpt = str(tmp_path / f"ckpt-{jit}")
        save_train_state(ckpt, state)
        target = (state if how == "same state" else
                  ttrain.init_train_state(trainable(jparams), spec))
        with torch.no_grad():  # the load must bring the weights back
            for p in target.params.parameters():
                p.add_(1.0)
        state = load_train_state(ckpt, target)
        assert state.step == 2
        rows = []
        for b in data[2:]:
            state, m = step(state, b)
            rows.append((m["loss"], m["grad_norm"]))
        ends[jit] = (rows, snapshot(state))
    for (l1, g1), (l0, g0) in zip(ends[True][0], ends[False][0]):
        assert torch.equal(l1, l0) and torch.equal(g1, g0)
    assert_equal_trees(ends[True][1], ends[False][1])


# (f) -------------------------------------------------------------------------

def test_metrics_are_tensors_of_their_own(jparams):
    """A step's loss and grad_norm keep their values through the next
    step, and are not the program's outputs."""
    spec = ttrain.make_optimizer(1e-3)
    step = ttrain.make_train_step(TCFG, spec)
    state = ttrain.init_train_state(trainable(jparams), spec)
    data = batches(18, 2)
    state, m1 = step(state, data[0])
    kept = (float(m1["loss"]), float(m1["grad_norm"]))
    state, m2 = step(state, data[1])
    assert (float(m1["loss"]), float(m1["grad_norm"])) == kept
    assert float(m2["loss"]) != kept[0]
    (prog,) = step.programs[torch.device("cpu")].table.values()
    for got, out in zip((m2["loss"], m2["grad_norm"]), prog.output):
        assert got.data_ptr() != out.data_ptr() and torch.equal(got, out)

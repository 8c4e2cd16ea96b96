"""The port's sharded train step as a program
(``_graphs.SegmentedTrainProgram``, ``train.make_sharded_train_step``) on
the CPU.

bert_tpu jits its sharded train step: one GSPMD program per batch shape
(``jax.jit(step_fn, in_shardings=...)``, bert_tpu/train.py:201-206). The
port keeps one program per (batch shapes, model, optimizer) on each rank:
on the card CUDA graphs between the step's collectives, the backward's
issued from autograd's device thread. On the CPU nothing is captured, but
the same program stages each rank's rows, records the step's collectives
and checks them across the ranks, so these tests hold, at
tests/test_torch_parallel_train.py's config (2 layers, D 64, 4 heads,
batches of 8 pairs × 8 tokens; ranks spawned over gloo, one spawn per
world size):

(a) the program bit for bit ``jit=False`` at (2, 2), (1, 2) and (2, 1)
    over 3 steps (loss, grad_norm, this rank's parameters and both
    moments), and at (2, 2) bert_tpu's ``make_sharded_train_step`` on 4
    of conftest's virtual CPU devices under test_torch_parallel_train.py's
    ``_hold`` (rtol 1e-5, ``noise_rule``);
(b) the plan: the step's collectives in order, as many as
    ``testing.sharded_train_plan`` derives, alike on every rank;
(c) the card's code path with fake CUDA objects over real gloo, the
    backward's collectives issued from another thread as autograd's
    device thread issues them: each collective ends a graph and begins
    the next (relaxed mode lets that thread end a graph the step's
    thread began), the capture runs nothing, the replay runs graph,
    collective, ... from the caller's thread;
(d) a capture or a replay that raises on one rank raises on every rank,
    and a failed replay takes part in its collectives with zeros;
(e) a state whose moments are placed anew gets a new program.
"""

import numpy as np
import pytest
import torch

from bert_tpu import train as jtrain
from bert_tpu.parallel.mesh import make_mesh as j_make_mesh
from bert_tpu_torch import testing
from bert_tpu_torch.parallel.multihost import spawn_ranks
from test_torch_parallel_train import (JCFG, LR, TCFG, _hold, host,
                                       jparams,  # noqa: F401 (fixture)
                                       pair_batches)

torch.set_num_threads(1)

MESHES = [(2, 2), (1, 2), (2, 1)]


@pytest.fixture(scope="module")
def ranks(jparams):
    """{(dp, tp): every rank's graphs_train result}, the fake card's
    results of two ranks, and bert_tpu's three sharded steps at (2, 2)."""
    params, batches = host(jparams), pair_batches()[:3]
    job = lambda dp, tp: ("graphs_train", dict(  # noqa: E731
        config=TCFG, params=params, dp=dp, tp=tp, lr=LR, batches=batches))
    two = spawn_ranks(2, testing.rank_jobs, [
        job(1, 2), job(2, 1), ("fake_train", {}),
        ("fake_train", dict(fail_capture=1)),
        ("fake_train", dict(fail_replay=1))])
    four = spawn_ranks(4, testing.rank_jobs, [job(2, 2)])

    jopt = jtrain.make_optimizer(LR)
    placed, jstep = jtrain.make_sharded_train_step(
        j_make_mesh(4, tp=2), JCFG, jopt,
        jtrain.init_train_state(jparams, jopt))
    jax_steps = []
    for b in batches:
        placed, m = jstep(placed, b)
        jax_steps.append({"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "params": host(placed.params),
                          "mu": host(placed.opt_state[0].mu),
                          "count": int(placed.opt_state[0].count)})
    return {(2, 2): [r[0] for r in four], (1, 2): [r[0] for r in two],
            (2, 1): [r[1] for r in two], "fake": [r[2:5] for r in two],
            "jax": jax_steps}


# (a) -------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp", MESHES)
def test_program_is_the_eager_step_bit_for_bit(ranks, dp, tp):
    for r in ranks[(dp, tp)]:
        assert len(r[True]) == len(r[False]) == 3
        for s, (got, want) in enumerate(zip(r[True], r[False]), 1):
            np.testing.assert_array_equal(got["loss"], want["loss"])
            np.testing.assert_array_equal(got["grad_norm"],
                                          want["grad_norm"])
            assert got["tensors"].keys() == want["tensors"].keys()
            for leaf, parts in got["tensors"].items():
                for name, a, b in zip(("param", "mu", "nu"), parts,
                                      want["tensors"][leaf]):
                    np.testing.assert_array_equal(
                        a, b, err_msg=f"step {s} {leaf} {name}")
        # every rank computes the same loss over the whole batch
        assert ([float(x["loss"]) for x in r[True]]
                == [float(x["loss"]) for x in ranks[(dp, tp)][0][True]])


def test_program_matches_bert_tpus_sharded_step(ranks):
    """(2, 2): the program's three steps against bert_tpu's on the same
    mesh shape; the AdamW count and the step follow."""
    got = ranks[(2, 2)][0][True]
    _hold(got, ranks["jax"], 1, "(2, 2) program")
    for i, (g, w) in enumerate(zip(got, ranks["jax"])):
        assert g["count"] == w["count"] == g["step"] == i + 1


# (b) -------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp", MESHES)
def test_plan_is_the_derived_one(ranks, dp, tp):
    n_layer = TCFG.n_layer
    for r in ranks[(dp, tp)]:
        assert r["keys"] == [((8, 8), (8, 8))]
        assert r["plan"] == r["want"]
        assert r["plan"] == ranks[(dp, tp)][0]["plan"]
        ops = [op for op, _, _ in r["plan"]]
        leaves, replicated = 17, 11
        assert len(ops) == (12 * n_layer * (tp > 1) + (2 + leaves) * (dp > 1)
                            + (replicated + 1) * (tp > 1))
        assert ops.count("broadcast") == replicated * (tp > 1)
        assert ops.count("all_gather") == 2 * (dp > 1)


# (c) -------------------------------------------------------------------------

# the first call: the step eagerly, its backward on the other thread
WARM = ["kernel", "all_reduce", "kernel@autograd", "all_reduce@autograd",
        "kernel@autograd", "all_reduce", "broadcast", "kernel"]
# the second call's capture: five segments, each collective recorded where
# it is issued, then one check across the ranks
CAPTURE = ["begin", "end", "begin", "end@autograd", "begin@autograd", "end",
           "begin", "end", "begin", "end", "check"]
REPLAY = ["replay", "all_reduce", "replay", "all_reduce", "replay",
          "all_reduce", "replay", "broadcast", "replay", "check"]


def _out(x):
    """The fake step's result on two ranks: ((x·1 + x·2)·2 summed over
    model, + 1) summed over both ranks, broadcast, times 3."""
    return (np.asarray(x, np.float32) * 72 + 6).astype(np.float32)


def test_fake_card_captures_the_backward_on_another_thread(ranks):
    for ok, _, _ in ranks["fake"]:
        calls = ok["calls"]
        assert [c["events"] for c in calls] == [WARM, CAPTURE + REPLAY,
                                                REPLAY, WARM]
        for c, x in zip(calls, testing.FAKE_TRAIN_INPUTS):
            np.testing.assert_array_equal(c["out"], _out(x))
        assert ok["graphs"] == [5]
        assert ok["plan"] == [["all_reduce", "all_reduce", "all_reduce",
                               "broadcast"]]
        # the warm run's 4 launches, then 4 each replay; the capture's are
        # taken back
        assert [c["launches"] for c in calls] == [4, 8, 12, 16]
        assert [c["grad_is_programs"] for c in calls] == [False, True,
                                                          True, False]
        # (e) the state's moments placed anew before the fourth call
        assert [c["program"] for c in calls] == [0, 0, 0, 1]


# (d) -------------------------------------------------------------------------

def test_a_capture_that_raises_on_one_rank_raises_on_every_rank(ranks):
    (_, r0, _), (_, r1, _) = ranks["fake"]
    assert r0["calls"][-1] == {
        "raised": "a sharded program failed on another rank",
        "events": CAPTURE}
    # rank 1 raised on the backward's thread inside its second segment,
    # which its capture ended, then checked
    assert r1["calls"][-1] == {"raised": "this capture fails",
                               "events": ["begin", "end", "begin", "end",
                                          "check"]}
    assert [len(r["calls"]) for r in (r0, r1)] == [2, 2]
    assert r0["graphs"] == r1["graphs"] == [0]


def test_a_replay_that_raises_on_one_rank_raises_on_every_rank(ranks):
    (_, _, r0), (_, _, r1) = ranks["fake"]
    assert r0["calls"][2] == {
        "raised": "a sharded program failed on another rank",
        "events": REPLAY}
    # rank 1 took part in every collective with zeros, then raised
    assert r1["calls"][2] == {
        "raised": "this replay fails",
        "events": ["replay", "all_reduce", "all_reduce", "all_reduce",
                   "broadcast", "check"]}

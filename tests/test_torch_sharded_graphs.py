"""The port's sharded programs (``_graphs.SegmentedProgram``) on the CPU.

bert_tpu runs a mesh engine's ``encode``/``encode_packed`` and
``make_sharded_encode_fn`` as one jitted shard_map program per batch
shape, its psums and the wire cast inside. The port keeps one program per
shape on a mesh too: on the card CUDA graphs that end at each collective,
which runs from the host between the replays, then the row all-gather over
``data``. On the CPU nothing is captured, but the same programs stage each
rank's rows, record their collectives and check them across ranks, so
these tests hold, at tests/test_torch_parallel.py's config (D 256, 4
heads, 2 layers; ranks spawned over gloo, one spawn per world size):

(a) mesh engines at (1, 2), (2, 1) and (2, 2): bit for bit the same
    engine with its programs set aside (the eager path), and within 1e-5
    of ``BertTPU(dp=, tp=)`` in f32 on a batch of packed rows and buckets
    (the sums run in other orders: a few f32 ulps, as there);
(b) ``make_sharded_encode_fn``'s programs within 1e-5 of bert_tpu's, both
    poolings, one program per (B, T) and tree, its result a copy;
(c) each program's collectives: 2·L all-reduces over the rank's
    ``model`` group where tp = 2, none where tp = 1, then one all-gather
    over its ``data`` group where dp > 1; alike on every rank;
(d) ``warmup()`` on a mesh makes the programs of bert_tpu's grid;
(e) the card's code path with fake CUDA objects over real gloo: capture
    begins and ends around each segment with no collective inside it,
    replay runs graph, collective, graph, all-gather, check; the counters
    count each replay once; a capture or a replay that raises on one rank
    raises on every rank;
(f) the wire cast before the gather is bit for bit the cast after it,
    and bert_tpu's cast, for f32, f16 and int8;
(g) the collectives' recorder paths: the ``"broadcast"`` Collective
    (recorded, run again, stood in for, its signature), the process's
    recorder taking a collective issued on another thread and given back
    after a raise, and an all-gather recorded inside an autograd
    Function's forward run again on its output.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bert_tpu.engine import BertTPU
from bert_tpu.parallel.mesh import make_mesh as j_make_mesh
from bert_tpu.parallel.spmd import make_sharded_encode_fn as j_encode_fn
from bert_tpu.parallel.spmd import shard_params as j_shard_params
from bert_tpu_torch import testing
from bert_tpu_torch.parallel.multihost import spawn_ranks
from test_torch_parallel import (CFG, JCFG, TCFG, WEIGHTS, batch,
                                 host_params, jax_loaded, jax_params,
                                 loaded, token_lists)

torch.set_num_threads(1)

ENGINE_KW = dict(compute_dtype=torch.float32, pack_seq=32)
WARMUP = dict(batch_sizes=[1, 8], max_rows=8)
MESHES = [(1, 2), (2, 1), (2, 2)]


def engine_job(dp, tp):
    return ("graphs_engine", dict(loaded=loaded(2), dp=dp, tp=tp,
                                  token_lists=token_lists(),
                                  engine_kw=ENGINE_KW, warmup=WARMUP))


def encode_job(dp, tp):
    ids, mask = batch()
    return ("graphs_encode", dict(
        config=TCFG, params_by_name={w: host_params(f)
                                     for w, f in WEIGHTS.items()},
        dp=dp, tp=tp, poolings=("mean", "cls"), ids=ids, mask=mask))


@pytest.fixture(scope="module")
def ranks():
    """{(dp, tp): (engine results, encode results) of every rank}, and
    the fake card's and the wire's results of two ranks."""
    ids, mask = batch()
    two = spawn_ranks(2, testing.rank_jobs, [
        engine_job(1, 2), encode_job(1, 2), engine_job(2, 1),
        encode_job(2, 1),
        ("wire", dict(loaded=loaded(2), dp=2, tp=1, ids=ids, mask=mask)),
        ("fake_card", {}), ("fake_card", dict(fail_capture=1)),
        ("fake_card", dict(fail_replay=1)), ("collectives", {})])
    four = spawn_ranks(4, testing.rank_jobs, [engine_job(2, 2),
                                              encode_job(2, 2)])
    return {(1, 2): [r[0:2] for r in two], (2, 1): [r[2:4] for r in two],
            (2, 2): four, "wire": [r[4] for r in two],
            "fake": [r[5:8] for r in two],
            "collectives": [r[8] for r in two]}


# (a) -------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp", MESHES)
def test_mesh_programs_are_bit_for_bit_their_eager_twin(ranks, dp, tp):
    for eng, _ in ranks[(dp, tp)]:
        first, second = eng["programs"]
        np.testing.assert_array_equal(first, eng["eager"])
        np.testing.assert_array_equal(second, eng["eager"])
        np.testing.assert_array_equal(first, ranks[(dp, tp)][0][0]["eager"])


@pytest.mark.parametrize("dp,tp", MESHES)
def test_mesh_programs_match_bert_tpu(ranks, dp, tp):
    eng = ranks[(dp, tp)][0][0]
    want = BertTPU(jax_loaded(2), compute_dtype=jnp.float32, pack_seq=32,
                   dp=dp, tp=tp).eval_tokens(token_lists())
    np.testing.assert_allclose(eng["programs"][0], want, atol=1e-5, rtol=0)
    buckets = eng["buckets"]
    assert any("packed" in k for k in buckets), buckets
    assert any("packed" not in k for k in buckets), buckets


# (b) -------------------------------------------------------------------------

@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("dp,tp", MESHES)
def test_sharded_encode_programs_match_bert_tpu(ranks, dp, tp, weights,
                                                pooling):
    ids, mask = batch()
    jp = jax_params(WEIGHTS[weights])
    mesh = j_make_mesh(dp * tp, tp=tp)
    fn = j_encode_fn(mesh, JCFG, compute_dtype=jnp.float32, pooling=pooling,
                     params_example=jp)
    want = np.asarray(fn(j_shard_params(mesh, jp), jnp.asarray(ids),
                         jnp.asarray(mask)))
    for _, enc in ranks[(dp, tp)]:
        got = enc[(weights, pooling)]
        # one program for the batch shape, whose second call's result did
        # not overwrite the first's
        assert got["keys"] == [(8, 24)]
        np.testing.assert_array_equal(got["first"], got["second"])
        assert got["first"].shape == want.shape == (8, CFG["n_embd"])
        np.testing.assert_allclose(got["first"], want, atol=1e-5, rtol=0)


# (c) -------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp", MESHES)
def test_segment_plan(ranks, dp, tp):
    n_layer = CFG["n_layer"]
    shapes = []
    for rank, (eng, enc) in enumerate(ranks[(dp, tp)]):
        model = [rank // tp * tp + i for i in range(tp)]
        data = [rank % tp + tp * i for i in range(dp)]
        want = ([("all_reduce", model)] * (2 * n_layer if tp > 1 else 0)
                + [("all_gather", data)] * (dp > 1))
        plans = list(eng["plans"].values())
        plans += [p for v in enc.values() for p in v["plans"]]
        fwd = [k for k in eng["plans"]]
        assert len(fwd) >= 2 and all(len(k) == 4 for k in fwd)
        assert plans and all(p == want for p in plans), (rank, plans[0])
        shapes.append(sorted(eng["plans"]))
    # every rank made the same programs
    assert all(s == shapes[0] for s in shapes)


# (d) -------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp", MESHES)
def test_warmup_on_a_mesh_makes_bert_tpus_grid(ranks, dp, tp, monkeypatch):
    calls = []
    monkeypatch.setattr(BertTPU, "_warm_shape",
                        lambda self, rows, seq, kind, **kw: calls.append(
                            (rows, seq, kind)))
    BertTPU(jax_loaded(2), compute_dtype=jnp.float32, pack_seq=32, dp=dp,
            tp=tp).warmup(**WARMUP)
    want = {(r, t, k, "q4/dense") for r, t, k in calls}
    want |= {(r, t, k, "q4/dense", 256) for r, t, k in calls
             if k == "packed"}
    assert any(k == "packed" for *_, k in calls) and len(calls) > 2
    for eng, _ in ranks[(dp, tp)]:
        assert eng["warm_keys"] == want
        # rows stay multiples of dp
        assert all(k[0] % dp == 0 for k in want)


# (e) -------------------------------------------------------------------------

CAPTURE = ["kernel", "all_reduce", "kernel",  # the warm run, eager
           "begin", "end", "begin", "end",  # two segments, no collective
           "check"]
REPLAY = ["replay", "all_reduce", "replay", "all_gather", "check"]


def test_fake_card_captures_segments_and_replays_in_order(ranks):
    for rank, (ok, _, _) in enumerate(ranks["fake"]):
        first, second = ok["calls"]
        assert first["events"] == CAPTURE + REPLAY
        assert second["events"] == REPLAY
        assert ok["graphs"] == 2 and ok["plan"] == ["all_reduce",
                                                    "all_gather"]
        # (x · (rank + 1)) summed over two ranks, doubled, gathered
        np.testing.assert_array_equal(first["out"], np.tile([6., 12., 18.],
                                                             2))
        np.testing.assert_array_equal(second["out"], np.tile([0., -6., 30.],
                                                             2))
        # the warm run's 2 launches, then 2 for each replay; the capture's
        # are taken back
        assert (first["launches"], second["launches"]) == (4, 6)


def test_a_capture_that_raises_on_one_rank_raises_on_every_rank(ranks):
    (r0,), (r1,) = ([f[1]["calls"]] for f in ranks["fake"])
    assert r0 == [{"raised": "a sharded program failed on another rank",
                   "events": CAPTURE}]
    # rank 1 raised at its first segment, which it ended, and checked
    assert r1 == [{"raised": "this capture fails",
                   "events": ["kernel", "all_reduce", "kernel", "begin",
                              "end", "check"]}]
    assert all(f[1]["graphs"] == 0 for f in ranks["fake"])


def test_a_replay_that_raises_on_one_rank_raises_on_every_rank(ranks):
    r0, r1 = (f[2]["calls"] for f in ranks["fake"])
    assert r0[1] == {"raised": "a sharded program failed on another rank",
                     "events": REPLAY}
    # rank 1 took part in the collectives with zeros, then raised
    assert r1[1] == {"raised": "this replay fails",
                     "events": ["replay", "all_reduce", "all_gather",
                                "check"]}


# (f) -------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["f32", "f16", "int8"])
def test_wire_before_the_gather_is_the_cast_after_it(ranks, wire):
    """(dp, tp) = (2, 1): each rank casts its rows, then they are
    gathered; casting the gathered f32 rows (the order before) gives the
    same bits, and so does bert_tpu's own wire cast."""
    gathered = ranks["wire"][0]["f32"]
    after = {"f32": gathered, "f16": torch.from_numpy(gathered).half(),
             "int8": torch.clamp(torch.round(torch.from_numpy(gathered)
                                             * 127.0), -127, 127).to(
                                                 torch.int8)}[wire]
    after = np.asarray(after)
    ref = BertTPU(jax_loaded(2), compute_dtype=jnp.float32, wire_dtype=wire)
    n = gathered.shape[0]
    theirs = np.asarray(ref._gather_segments_jit(jnp.asarray(gathered)[None],
                                                 jnp.arange(n)))
    for r in ranks["wire"]:
        got = r[wire]
        assert got.dtype == after.dtype == theirs.dtype
        np.testing.assert_array_equal(got, after)
        np.testing.assert_array_equal(got, theirs)
    if wire == "int8":  # unit rows of 256 lanes: small codes, many
        assert len(np.unique(after)) > 16


# (g) -------------------------------------------------------------------------

def test_broadcast_collective_is_recorded_and_run_again(ranks):
    for got in ranks["collectives"]:
        np.testing.assert_array_equal(got["eager"], [1.0] * 3)
        op, same, value, signature = got["recorded"]
        # the CPU's recorder runs the broadcast and records it; the
        # signature is alike on every rank (rank 0 the source of each)
        assert (op, same) == ("broadcast", True)
        np.testing.assert_array_equal(value, [1.0] * 3)
        assert signature == ("broadcast", 2, (3,), "torch.float32", 0)
        np.testing.assert_array_equal(got["run"], [10.0] * 3)
    r0, r1 = ranks["collectives"]
    # the source stands in with zeros, so its peer gets them; a peer that
    # stands in leaves the source's tensor as it was
    np.testing.assert_array_equal(r1["rank 0 stands in"], [0.0] * 3)
    np.testing.assert_array_equal(r0["rank 1 stands in"], [7.0] * 3)


def test_every_thread_recorder_takes_another_threads_collective(ranks):
    for got in ranks["collectives"]:
        assert got["every_thread"] == (["broadcast"], None, False)


def test_a_recorded_gather_runs_again_on_autograds_output(ranks):
    for got in ranks["collectives"]:
        requires_grad, same, rows = got["gather"]
        assert requires_grad and same
        np.testing.assert_array_equal(rows, [[-1.0] * 3] * 2
                                      + [[-2.0] * 3] * 2)

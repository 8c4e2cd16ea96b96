"""The port's multi-device execution on the CPU against bert_tpu's.

At tests/test_engine_parallel.py's config (D 256, F 512, 4 heads, 2
layers; Q4_0 at tp = 4 is Q4-aligned) the same host weights and seeded
token ids go through bert_tpu's sharded programs on conftest's 8 virtual
CPU devices and through the port's, whose ranks are processes spawned
over gloo (parallel.multihost.spawn_ranks). One spawn per world size runs
every case of that size (testing.rank_jobs); each rank checks that it
imported neither JAX nor bert_tpu, and every rank must return the same
result. In f32 the port is held to bert_tpu within 1e-5: the sums of the
all-reduces and matmuls run in other orders, so equal arithmetic agrees
to a few f32 ulps, not bit for bit.
"""

import os
import re
import signal
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bert_tpu.engine import BertTPU
from bert_tpu.loader import LoadedModel as JLoaded
from bert_tpu.params import BertConfig as JConfig
from bert_tpu.params import params_from_named_tensors as j_params_from_named
from bert_tpu.params import params_to_int8 as j_params_to_int8
from bert_tpu.params import random_named_tensors as j_random_named
from bert_tpu.parallel import sharding as jsharding
from bert_tpu.parallel.mesh import make_mesh as j_make_mesh
from bert_tpu.parallel.spmd import make_sharded_encode_fn as j_encode_fn
from bert_tpu.parallel.spmd import shard_params as j_shard_params
from bert_tpu.vocab import Vocab as JVocab
from bert_tpu_torch import testing
from bert_tpu_torch.engine import BertTorch
from bert_tpu_torch.loader import LoadedModel
from bert_tpu_torch.parallel import sharding
from bert_tpu_torch.parallel.multihost import spawn_ranks
from bert_tpu_torch.params import BertConfig, params_to_int8
from bert_tpu_torch.params import params_from_named_tensors
from bert_tpu_torch.params import random_named_tensors
from bert_tpu_torch.quant import QuantTensor
from bert_tpu_torch.vocab import Vocab

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(n_vocab=256, n_max_tokens=64, n_embd=256, n_intermediate=512,
           n_head=4, n_layer=2, ftype=2)
JCFG, TCFG = JConfig(**CFG), BertConfig(**CFG)
SEED = 9
WEIGHTS = {"dense": None, "q4_0": 2}
# both packed (≤ 32) and bucketed (> 32) routes
MIXED = [5, 7, 30, 12, 9, 21, 17, 4, 28, 31, 40, 64, 48, 33, 60, 11, 8]
ENGINE_KW = dict(compute_dtype=torch.float32, pack_seq=32)
INT8_KW = dict(int8_eval=True, int8_threshold=0)  # every batch int8


def host_params(ftype):
    return params_from_named_tensors(random_named_tensors(TCFG, SEED), TCFG,
                                     quantize_ftype=ftype)


def jax_params(ftype):
    return j_params_from_named(j_random_named(JCFG, SEED), JCFG,
                               quantize_ftype=ftype)


def loaded(ftype):
    return LoadedModel(config=TCFG, params=host_params(ftype),
                       vocab=Vocab(tokens=[f"tok{i}" for i in range(256)]))


def jax_loaded(ftype):
    return JLoaded(config=JCFG, params=jax_params(ftype),
                   vocab=JVocab(tokens=[f"tok{i}" for i in range(256)]))


def batch():
    """[8, 24] ids with ragged padding, a row of 1 token among them."""
    rng = np.random.default_rng(3)
    ids = rng.integers(1, CFG["n_vocab"], (8, 24)).astype(np.int32)
    mask = np.ones((8, 24), np.float32)
    for i, n in enumerate([24, 1, 9, 17, 24, 3, 12, 20]):
        mask[i, n:] = 0.0
    ids[mask == 0] = 0
    return ids, mask


def token_lists():
    rng = np.random.default_rng(23)
    return [rng.integers(0, CFG["n_vocab"], size=n).astype(np.int32).tolist()
            for n in MIXED]


def encode_job(dp, tp):
    ids, mask = batch()
    return ("encode", dict(
        config=TCFG, params_by_name={w: host_params(f)
                                     for w, f in WEIGHTS.items()},
        dp=dp, tp=tp, poolings=("mean", "cls"), ids=ids, mask=mask))


def same_on_every_rank(results):
    """The ranks' results (each a list of job results) → rank 0's, after
    checking that every rank got exactly the same arrays."""
    first = results[0]
    for other in results[1:]:
        for a, b in zip(first, other):
            if isinstance(a, dict):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
            elif isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(a[0], b[0])
                assert a[1] == b[1]
    return first


@pytest.fixture(scope="module")
def world4():
    jobs = [encode_job(2, 2), encode_job(1, 4),
            ("engine", dict(loaded=loaded(2), dp=2, tp=2,
                            token_lists=token_lists(), engine_kw=ENGINE_KW)),
            ("multihost", dict(tp=2))]
    ranks = spawn_ranks(4, testing.rank_jobs, jobs)
    multihost = [r.pop() for r in ranks]
    return same_on_every_rank(ranks) + [multihost]


@pytest.fixture(scope="module")
def world2():
    jobs = [encode_job(1, 2), encode_job(2, 1),
            ("engine", dict(loaded=loaded(2), dp=1, tp=2,
                            token_lists=token_lists(),
                            engine_kw=dict(ENGINE_KW, **INT8_KW),
                            record=True)),
            ("engine", dict(loaded=loaded(None), dp=1, tp=2,
                            token_lists=token_lists(),
                            engine_kw=dict(compute_dtype=torch.bfloat16,
                                           pack_seq=32))),
            ("row_parallel", dict(zip(("h", "w"), row_parallel_operands()),
                                  tp=2)),
            ("server", dict(loaded=loaded(None), dp=1, tp=2,
                            token_lists=token_lists()[:6],
                            engine_kw=ENGINE_KW))]
    ranks = spawn_ranks(2, testing.rank_jobs, jobs)
    # the int8 job's events: each rank quantizes its own K shards
    int8_events = [r[2][2] for r in ranks]
    return same_on_every_rank(ranks) + [int8_events]


def row_parallel_operands():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((64, 512)).astype(np.float32),
            (0.05 * rng.standard_normal((512, 256))).astype(np.float32))


MESHES = {(2, 2): ("world4", 0), (1, 4): ("world4", 1),
          (1, 2): ("world2", 0), (2, 1): ("world2", 1)}


@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("dp,tp", sorted(MESHES))
def test_sharded_encode_matches_bert_tpu(request, dp, tp, weights,
                                         pooling):
    """make_sharded_encode_fn on a (dp, tp) mesh against bert_tpu's on
    the same mesh of virtual devices, f32, within 1e-5."""
    world, job = MESHES[(dp, tp)]
    got = request.getfixturevalue(world)[job][(weights, pooling)]
    ids, mask = batch()
    jp = jax_params(WEIGHTS[weights])
    mesh = j_make_mesh(dp * tp, tp=tp)
    fn = j_encode_fn(mesh, JCFG, compute_dtype=jnp.float32, pooling=pooling,
                     params_example=jp)
    want = np.asarray(fn(j_shard_params(mesh, jp), jnp.asarray(ids),
                         jnp.asarray(mask)))
    assert got.shape == want.shape == (8, CFG["n_embd"])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_sharded_engine_matches_bert_tpu(world4):
    """BertTorch(dp=2, tp=2).eval_tokens against BertTPU(dp=2, tp=2) on a
    mixed-length batch that takes packed rows and buckets, f32."""
    got, buckets = world4[2]
    want = BertTPU(jax_loaded(2), compute_dtype=jnp.float32, pack_seq=32,
                   dp=2, tp=2).eval_tokens(token_lists())
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert any("packed" in k for k in buckets), buckets
    assert any("packed" not in k for k in buckets), buckets


def _jax_int8(monkeypatch, **kw):
    """BertTPU(int8_eval=True, **kw).eval_tokens(token_lists()), f32,
    with every activation quantization recorded as (x, codes): the
    embeddings and the records, in no set order (under shard_map a
    callback runs on each device)."""
    import jax

    import bert_tpu.ops.int8_matmul as ji8

    records, quantize = [], ji8.quantize_activations_i8

    def recorded(x):
        codes, sx = quantize(x)
        jax.debug.callback(lambda x, c: records.append(
            (np.asarray(x, np.float32), np.asarray(c))), x, codes)
        return codes, sx

    monkeypatch.setattr(ji8, "quantize_activations_i8", recorded)
    want = BertTPU(jax_loaded(2), compute_dtype=jnp.float32, pack_seq=32,
                   **INT8_KW, **kw).eval_tokens(token_lists())
    jax.effects_barrier()
    return want, records


def _row_owners(ids, seg, lists):
    """Each token row of a forward's [B, T] ``ids``: the index in
    ``lists`` of the sentence it belongs to, -1 on padding (``seg``: the
    packed segment ids, or a bucketed batch's mask)."""
    index = {tuple(t): i for i, t in enumerate(lists)}
    assert len(index) == len(lists)
    owner = np.full(ids.shape, -1)
    for b in range(ids.shape[0]):
        for s in np.unique(seg[b][seg[b] > 0]):
            at = seg[b] == s
            owner[b, at] = index[tuple(ids[b, at].tolist())]
    return owner.reshape(-1)


def _half_step(x, r, k):
    """x[r, k] · 127 / max|x[r]|, the value the code rounds (f64)."""
    return float(x[r, k]) * 127.0 / float(np.abs(x[r]).max())


def explain_int8_differences(got, want, port_events, jax_records):
    """Hold the int8 regime's sentences to bert_tpu's within 1e-5 where
    their activation codes agree. Each of the port's quantizations (every
    rank's, ``port_events`` from testing.int8_codes_recorded, the ranks in
    step) is paired with bert_tpu's of the same shape and nearest x, and
    the codes compared. A sentence whose codes differ somewhere is
    explained by its first flips, on any rank, the roots: there both
    packages' x agree to f32 rounding (|Δ(x·inv)| <= 1e-4) and x·inv lies
    within 1e-4 of k + 0.5, so one ulp decided the code. Such a sentence,
    the flip carried through the later products and all-reduces, is held
    to 1e-4. Returns the flipped sentences and the number of roots."""
    lists = token_lists()
    assert len({len(events) for events in port_events}) == 1
    flipped, roots = set(), 0
    for step in zip(*port_events):
        before = set(flipped)  # carried to every rank by the all-reduces
        for kind, a, b in step:
            if kind == "batch":
                owner = _row_owners(a, b, lists)
                continue
            x, codes = a, b
            xj, cj = min((r for r in jax_records if r[0].shape == x.shape),
                         key=lambda r: float(np.abs(r[0] - x).max()))
            for r, k in np.argwhere(codes != cj):
                s = int(owner[r])
                if s < 0 or s in before:
                    continue  # padding, or carried from an earlier flip
                ut, uj = _half_step(x, r, k), _half_step(xj, r, k)
                assert abs(ut - uj) <= 1e-4, (s, r, k, ut, uj)
                assert abs(abs(ut - np.floor(ut)) - 0.5) <= 1e-4, (s, ut)
                flipped.add(s)
                roots += 1
    clean = [i for i in range(len(lists)) if i not in flipped]
    np.testing.assert_allclose(got[clean], want[clean], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    return sorted(flipped), roots


def test_sharded_int8_matches_bert_tpu(world2, monkeypatch):
    """The W8A8 regime at tp = 2 (every batch int8) against
    BertTPU(int8_eval=True, tp=2): the row-parallel products quantize
    each rank's K shard of the activations per row, in both. Every
    sentence whose codes agree with bert_tpu's is held to 1e-5; a code
    moves by one only where x·inv sits on a rounding boundary
    (explain_int8_differences)."""
    got = world2[2][0]
    want, records = _jax_int8(monkeypatch, tp=2)
    flipped, roots = explain_int8_differences(got, want, world2[6], records)
    assert len(flipped) < len(want) // 2, flipped


def test_int8_matches_bert_tpu_at_this_width(monkeypatch):
    """The single-device W8A8 regime at D 256 against bert_tpu's, on the
    same batch and under the same rule: 1e-5 where the codes agree, a
    flip explained by a rounding boundary where they do not."""
    want, records = _jax_int8(monkeypatch)
    eng = BertTorch(loaded(2), device="cpu", **ENGINE_KW, **INT8_KW)
    with testing.int8_codes_recorded() as events:
        got = eng.eval_tokens(token_lists())
    flipped, roots = explain_int8_differences(got, want, [events], records)
    assert len(flipped) < len(want) // 2, flipped


def test_bf16_tp2_matches_tp1(world2):
    """The port's own tp = 2 against its tp = 1 in bf16, dense weights,
    at the bf16 golden bound 5e-3: the partial products are rounded to
    bf16 and summed in bf16 (bert_tpu's psum of rounded partials), the
    single device rounds the whole product once."""
    got, _ = world2[3]
    ref = BertTorch(loaded(None), device="cpu", compute_dtype=torch.bfloat16,
                    pack_seq=32).eval_tokens(token_lists())
    assert float(np.abs(got - ref).max()) <= 5e-3


def test_tp_all_reduce_sums_rounded_partials(world2):
    """Under tensor parallelism the row-parallel product is bert_tpu's
    (model.py:70, :76-77, :151-152): each rank's partial product rounded
    to bf16, the rounded partials summed in bf16. Bit for bit that, and
    not the f32 partials summed and rounded once (which differs)."""
    got = world2[4]
    h, w = row_parallel_operands()
    hb = torch.from_numpy(h).to(torch.bfloat16)
    wt = torch.from_numpy(w)
    parts = [(hb[:, r * 256:(r + 1) * 256].float()
              @ wt[r * 256:(r + 1) * 256].to(torch.bfloat16).float())
             for r in range(2)]
    rounded = (parts[0].to(torch.bfloat16) + parts[1].to(torch.bfloat16))
    np.testing.assert_array_equal(got, rounded.float().numpy())
    once = (parts[0] + parts[1]).to(torch.bfloat16).float().numpy()
    assert (got != once).any()


def test_sharded_server_survives_a_failed_batch(world2):
    """A batch that raises on every rank at tp = 2 costs that batch only,
    as on one device: rank 0's scheduler fails it and closes that
    connection, the follower logs it and keeps following, and the next
    BATCH message is answered with the single-rank result."""
    got, (first_failed, raised) = world2[5]
    assert first_failed and raised == 1
    lists = token_lists()[:6]
    ref = BertTorch(loaded(None), device="cpu",
                    **ENGINE_KW).eval_tokens(lists)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_multihost_plumbing(world4):
    """global_mesh(2) over 4 ranks: rank r is at data coordinate r // 2
    and holds that half of a batch's rows; the rows put back
    together give the batch on every rank; allgather stacks the data
    axis's ranks; a tp that does not divide the host's ranks is refused,
    as bert_tpu refuses it."""
    whole = np.arange(16, dtype=np.float32).reshape(8, 2)
    for rank, r in enumerate(world4[3]):
        d = rank // 2
        np.testing.assert_array_equal(r["mine"], whole[4 * d:4 * d + 4])
        np.testing.assert_array_equal(r["whole"], whole)
        np.testing.assert_array_equal(r["ranks"].ravel(), [rank % 2,
                                                           rank % 2 + 2])
        assert r["refusal"] == ("tp=5 must divide local device count 4 so "
                                "TP collectives stay inside one host (never "
                                "the network)")


def test_init_distributed_errors_are_bert_tpu_s(monkeypatch):
    from bert_tpu.parallel import multihost as jmh

    from bert_tpu_torch.parallel import multihost as tmh

    for var in (tmh.ENV_COORD, tmh.ENV_NPROC, tmh.ENV_PID):
        monkeypatch.delenv(var, raising=False)
    msgs = []
    for mod in (jmh, tmh):
        with pytest.raises(ValueError) as e:
            mod.init_distributed("127.0.0.1:1234", num_processes=2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_batch_check_is_bert_tpu_s():
    """A batch that dp does not divide: bert_tpu's message."""
    from bert_tpu.parallel.spmd import _local_batch_check

    from bert_tpu_torch.parallel.mesh import local_rows

    jmesh = j_make_mesh(2, tp=1)
    with pytest.raises(ValueError) as want:
        _local_batch_check(jmesh, "data", 7)
    with pytest.raises(ValueError) as got:
        local_rows(_FakeMesh(2, 1), 7)
    assert str(got.value) == str(want.value)


class _FakeMesh:
    """A (data, model) mesh of the given sizes, as far as the engine's
    checks read one (they run before any collective)."""

    mesh_dim_names = ("data", "model")
    device_type = "cpu"

    def __init__(self, dp, tp):
        self._sizes = (dp, tp)

    def size(self, i):
        return self._sizes[i]


@pytest.mark.parametrize("dp,max_batch", [(3, 12), (2, 7)])
def test_dp_errors_are_bert_tpu_s(dp, max_batch):
    """dp a power of two and max_batch a multiple of it, with bert_tpu's
    messages."""
    with pytest.raises(ValueError) as want:
        BertTPU(jax_loaded(2), mesh=j_make_mesh(dp, tp=1),
                max_batch=max_batch)
    with pytest.raises(ValueError) as got:
        BertTorch(loaded(2), device="cpu", mesh=_FakeMesh(dp, 1),
                  max_batch=max_batch)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_embd,n_int,n_head,tp,quantized", [
    (256, 512, 3, 2, False), (256, 510, 4, 4, False),
    (128, 512, 4, 4, True), (256, 192, 4, 4, True), (256, 512, 4, 4, True)])
def test_check_tp_divisibility_is_bert_tpu_s(n_embd, n_int, n_head, tp,
                                             quantized):
    cfg = dict(n_vocab=8, n_max_tokens=8, n_embd=n_embd,
               n_intermediate=n_int, n_head=n_head, n_layer=1)
    outcome = []
    for check, conf in ((jsharding.check_tp_divisibility, JConfig(**cfg)),
                        (sharding.check_tp_divisibility, BertConfig(**cfg))):
        try:
            check(conf, tp, quantized)
            outcome.append(None)
        except ValueError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1]
    assert (outcome[0] is None) == ((n_embd, n_int, n_head) == (256, 512, 4))


def test_engine_refuses_unaligned_quantized_tp():
    bad = BertConfig(n_vocab=256, n_max_tokens=64, n_embd=128,
                     n_intermediate=512, n_head=4, n_layer=2, ftype=2)
    lm = LoadedModel(config=bad, params=params_from_named_tensors(
        random_named_tensors(bad, 1), bad, quantize_ftype=2),
        vocab=Vocab(tokens=[f"tok{i}" for i in range(256)]))
    with pytest.raises(ValueError, match="multiple of 64"):
        BertTorch(lm, device="cpu", mesh=_FakeMesh(1, 4))


def _jax_shards(tree, tp):
    """bert_tpu's shard_params of ``tree`` on a (1, tp) mesh: for each
    leaf path, the numpy data of model rank 0..tp-1."""
    import jax

    mesh = j_make_mesh(tp, tp=tp)
    placed = j_shard_params(mesh, tree)
    devs = list(mesh.devices.reshape(-1))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        by_dev = {s.device: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        out[jax.tree_util.keystr(path)] = [by_dev[d] for d in devs]
    return out


def _port_leaves(tree):
    """(keystr as jax writes it, array) for every leaf of a port tree: a
    QuantTensor's packed, scales, mins and an Int8Tensor's w_i8, scale are
    its flat indices 0, 1, 2."""
    for group, sub in tree.items():
        for key, v in sub.items():
            base = f"['{group}']['{key}']"
            if isinstance(v, QuantTensor):
                fields = [v.packed, v.scales, v.mins]
            elif hasattr(v, "w_i8"):
                fields = [v.w_i8, v.scale]
            else:
                yield base, v
                continue
            for i, a in enumerate(f for f in fields if f is not None):
                yield f"{base}[<flat index {i}>]", a


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("tree", ["q4_0", "q4_1", "int8"])
def test_shard_params_cuts_equal_bert_tpu_s(tree, tp):
    """sharding.shard_params's host cut of QuantTensor and Int8Tensor
    trees equals bert_tpu's per-device shards bit for bit (the int8
    scale cut with N under column parallelism, whole under row)."""
    ftype = {"q4_0": 2, "q4_1": 3, "int8": 2}[tree]
    jp, tp_host = jax_params(ftype), host_params(ftype)
    if tree == "int8":
        jp, tp_host = j_params_to_int8(jp), params_to_int8(tp_host)
    want = _jax_shards(jp, tp)
    for rank in range(tp):
        got = dict(_port_leaves(sharding.shard_params(tp_host, tp, rank)))
        assert set(got) == set(want)
        for k, v in got.items():
            w = want[k][rank]
            assert v.shape == w.shape and v.dtype == w.dtype, k
            np.testing.assert_array_equal(v, w, err_msg=f"{k} rank {rank}")


# -- entry points under the launcher ----------------------------------------

def _ggml(path):
    from bert_tpu_torch.formats import GgmlHParams, write_ggml

    hp = GgmlHParams(TCFG.n_vocab, TCFG.n_max_tokens, TCFG.n_embd,
                     TCFG.n_intermediate, TCFG.n_head, TCFG.n_layer,
                     ftype=2)
    write_ggml(path, hp, [f"tok{i}" for i in range(TCFG.n_vocab)],
               random_named_tensors(TCFG, SEED))
    return path


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(nproc, module, *args):
    return [sys.executable, "-m", "torch.distributed.run",
            f"--nproc-per-node={nproc}", "--master-addr=127.0.0.1",
            f"--master-port={_free_port()}", "-m", module, *args]


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def test_server_under_torchrun_answers_batch(tmp_path):
    """``torchrun -m bert_tpu_torch.server --dp 1 --tp 2 --device cpu``:
    rank 0 answers a framed BATCH message with the single-rank result
    (f32, within 1e-5), rank 1 following; SIGTERM stops both."""
    from bert_tpu_torch.server import BIN_BATCH_MAGIC

    model = _ggml(str(tmp_path / "m.bin"))
    port = _free_port()
    proc = subprocess.Popen(
        _torchrun(2, "bert_tpu_torch.server", "-m", model, "--device", "cpu",
                  "--dp", "1", "--tp", "2", "--port", str(port),
                  "--host", "127.0.0.1", "--no-warmup"),
        cwd=str(tmp_path), env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    lists = token_lists()[:6]
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                sock = socket.create_connection(("127.0.0.1", port), 1.0)
                break
            except OSError:
                assert time.monotonic() < deadline, "server did not start"
                time.sleep(0.2)
        with sock:
            sock.settimeout(120)
            (n_embd,) = struct.unpack("<i", sock.recv(4))
            msg = BIN_BATCH_MAGIC + struct.pack("<i", len(lists))
            for t in lists:
                msg += struct.pack("<i", len(t)) + np.asarray(
                    t, "<i4").tobytes()
            sock.sendall(msg)
            want_bytes = len(lists) * n_embd * 4
            buf = b""
            while len(buf) < want_bytes:
                more = sock.recv(want_bytes - len(buf))
                assert more, "server closed the connection"
                buf += more
        got = np.frombuffer(buf, "<f4").reshape(len(lists), n_embd)
    finally:
        os.killpg(proc.pid, signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    ref = BertTorch.from_file(model, device="cpu").eval_tokens(lists)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert out.count("Server running on port") == 1, out


def test_cli_under_torchrun_prints_once(tmp_path):
    """``torchrun -m bert_tpu_torch.cli --tp 2``: every rank embeds the
    prompt, rank 0 alone prints, and its vector is the single-rank one."""
    model = _ggml(str(tmp_path / "m.bin"))
    r = subprocess.run(
        _torchrun(2, "bert_tpu_torch.cli", "-m", model, "--device", "cpu",
                  "--dtype", "f32", "--tp", "2", "-p", "tok5 tok9 tok77"),
        cwd=str(tmp_path), env=_env(), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("embedding (256):") == 1, r.stdout
    single = subprocess.run(
        [sys.executable, "-m", "bert_tpu_torch.cli", "-m", model,
         "--device", "cpu", "--dtype", "f32", "-p", "tok5 tok9 tok77"],
        cwd=str(tmp_path), env=_env(), capture_output=True, text=True,
        timeout=300)
    assert single.returncode == 0, single.stdout + single.stderr

    def vec(out):
        text = re.search(r"embedding \(256\):\n(.*?)\n\n", out,
                         re.S).group(1)
        return np.array([float(x) for x in re.findall(r"-?\d+\.\d+", text)])
    np.testing.assert_allclose(vec(r.stdout), vec(single.stdout), atol=2e-6)

"""The port's profiling module and the server's scheduler trace, against
bert_tpu's.

``roofline`` is bert_tpu's formula with the H100's ceilings as defaults:
given the v5e peaks it must equal bert_tpu's field by field. ``trace``
writes a Chrome trace of a CPU forward. ``BERT_TPU_SCHED_TRACE`` makes
both servers' schedulers append one JSON line per dispatched batch, with
the same keys in the same order and monotonic times.
"""

import asyncio
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from bert_tpu import profiling as jprof
from bert_tpu import server as jserver
from bert_tpu.params import BertConfig as JConfig
from bert_tpu_torch import profiling as tprof
from bert_tpu_torch import server as tserver
from bert_tpu_torch.params import BertConfig

CONFIGS = [dict(n_vocab=30522, n_max_tokens=512, n_embd=384,
                n_intermediate=1536, n_head=12, n_layer=6),
           dict(n_vocab=30522, n_max_tokens=512, n_embd=768,
                n_intermediate=3072, n_head=12, n_layer=12)]


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("batch,seq", [(1, 16), (64, 128), (16, 512)])
@pytest.mark.parametrize("cfg", [0, 1], ids=["minilm_l6", "bert_base"])
def test_roofline_with_v5e_peaks_is_bert_tpu_s(cfg, batch, seq, quantized):
    kw = dict(quantized=quantized, peak_flops=jprof.V5E_BF16_FLOPS,
              peak_bw=jprof.V5E_HBM_BW)
    got = tprof.roofline(BertConfig(**CONFIGS[cfg]), batch, seq, **kw)
    want = jprof.roofline(JConfig(**CONFIGS[cfg]), batch, seq, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.utilization(2 * got.sol_s) == want.utilization(2 * want.sol_s)


def test_roofline_defaults_to_the_h100():
    c = BertConfig(**CONFIGS[0])
    got = tprof.roofline(c, 8, 128)
    assert (tprof.H100_BF16_FLOPS, tprof.H100_HBM_BW) == (989e12, 3.35e12)
    assert got.sol_compute_s == got.flops / 989e12
    assert got.sol_memory_s == (got.weight_bytes
                                + got.activation_bytes) / 3.35e12
    assert not any("v5e" in name.lower() for name in vars(tprof))


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.matmul(torch.ones(64, 64), torch.ones(64, 64))
    (path,) = tmp_path.iterdir()
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


class _FakeEngine:
    """What a scheduler reads of an engine; ``eval_tokens`` sleeps a
    little, so that batches form while one runs."""

    n_max_tokens = 16

    class tokenizer:  # noqa: N801
        @staticmethod
        def tokenize_batch(texts, n):
            return [[101, len(t), 102] for t in texts]

    def eval_tokens(self, toks):
        import time

        time.sleep(0.003)
        return np.zeros((len(toks), 4), np.float32)


def _run_trace(module, path, monkeypatch):
    monkeypatch.setenv("BERT_TPU_SCHED_TRACE", str(path))

    async def go():
        sched = module.BatchingScheduler(_FakeEngine(), max_batch=4)
        sched.start()
        await asyncio.gather(*(sched.submit_tokens([101, i, 102])
                               for i in range(10)))
        await asyncio.gather(*(sched.submit(f"text {i}") for i in range(3)))
        await sched.stop()

    asyncio.run(go())
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def test_sched_trace_has_bert_tpu_s_keys(tmp_path, monkeypatch):
    got = _run_trace(tserver, tmp_path / "port.jsonl", monkeypatch)
    want = _run_trace(jserver, tmp_path / "jax.jsonl", monkeypatch)
    assert [list(r) for r in got][:1] == [list(r) for r in want][:1] == [
        ["t_first", "t_collect", "n_collect", "t_slot", "t_eval0", "t_eval1",
         "n"]]
    assert all(list(r) == list(got[0]) for r in got)
    assert sum(r["n"] for r in got) == 13
    prev = 0.0
    for r in got:
        times = [r[k] for k in ("t_first", "t_collect", "t_slot", "t_eval0",
                                "t_eval1")]
        assert times == sorted(times) and times[0] >= prev, r
        assert 1 <= r["n_collect"] <= r["n"] <= 4
        prev = r["t_first"]


def test_no_sched_trace_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("BERT_TPU_SCHED_TRACE", raising=False)
    sched = tserver.BatchingScheduler(_FakeEngine())
    assert sched._trace is None
    assert not os.listdir(tmp_path)

"""The control one step below bfloat16 for a cell whose program has no
lower-precision regime of its own (DeepSeek-V2: its experts are Q4_0 and
the engine refuses ``int8_eval``), run through the harness's own run and
comparison (``run.execute``, on the card):

    python3 -m gpubench.fp8_control \\
        --workload deepseek_v2_lite_q4_0.passage_bulk --seconds 45 \\
        --seeds <n> ...

In the program's place stands the architecture's plain reference computed
with every product's operands rounded to float8 e4m3
(``precision="fp8"``): each ``encode_batch`` of the cell's traffic returns
its embeddings. The reference runs each text alone, so the window runs the
traffic's calls cut to ``--call-size`` texts, with no warm-up; the harness
keeps its answers by the traffic's ``check`` (per call, then the sample
and the window's longest text), holds them against the f32 reference at
the cell's committed limits and decides ``correct``, which has to come out
false. Then the f32 reference runs once more over the compared texts and
counts its (token, MoE layer) top-k choices that lie within one bf16 ulp
of a tie (p_k - p_k+1 < 2^-8 p_k), where bf16 and f32 may choose
differently. One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from . import run
from .registry import Registry, load_benchmark

# bf16 keeps 8 significant bits: a gap below 2^-8 of the k-th probability
# may be rounded away
TIE = 2.0 ** -8


class ReferenceEngine:
    """The part of the engine that the bulk loop uses, answered by the
    plain reference at ``precision``: no shapes to warm, no programs."""

    max_batch = 1

    def __init__(self, cell: run.Cell, precision: str):
        self.ref = cell.arch.Reference(
            cell.arch.draw(cell.cfg, cell.weight_seed(), cell.device),
            cell.cfg, cell.device, precision=precision)
        self.tokenize = cell.corpus.tokenizer()
        self.cap = cell.cap

    def encode_batch(self, texts):
        emb = self.ref.embed([self.tokenize(t, self.cap) for t in texts])
        return emb.cpu().numpy().astype(np.float32)

    def seen_shapes(self):
        return []


def near_ties(cell: run.Cell, texts) -> dict:
    """The f32 reference over ``texts``: its (token, MoE layer) choices,
    and those within ``TIE`` of a tie between the k-th and k+1-th
    expert."""
    import torch

    count = {"pairs": 0, "near": 0}

    class Counting(cell.arch.Reference):
        def route(self, h, router):
            p = torch.softmax(self.mm(h, router), dim=-1)
            top = torch.topk(p, self.top_k + 1, dim=-1).values
            gap = (top[:, -2] - top[:, -1]) / top[:, -2]
            count["pairs"] += int(gap.numel())
            count["near"] += int((gap < TIE).sum())
            return super().route(h, router)

    tok = cell.corpus.tokenizer()
    ref = Counting(cell.arch.draw(cell.cfg, cell.weight_seed(), cell.device),
                   cell.cfg, cell.device)
    ref.embed([tok(t, cell.cap) for t in texts])
    del ref
    run.free(cell)
    count["share"] = count["near"] / max(count["pairs"], 1)
    return count


def control(bench: dict, name: str, seed: int, seconds: float,
            call_size: int, device, registry: Registry) -> dict:
    """One run of the cell ``name`` with the fp8 reference in the
    program's place; the harness's result, with the near ties of the f32
    reference's routing on the compared texts under ``near_ties``."""
    cell = run.make_cell(bench, name, seed, seconds, False, device,
                         registry, time.monotonic())
    stand_in = ReferenceEngine(cell, "fp8")
    r = run.execute(bench, name, seed, seconds, False, device, registry,
                    time.monotonic(), engine=stand_in, keep_answers=True,
                    mix_overrides={"call_size": call_size, "warm_calls": 0,
                                   "min_warm_calls": 0, "stable_calls": 0})
    del stand_in
    run.free(cell)
    texts = list(dict.fromkeys(t for t, _ in r.pop("answers")))
    r["near_ties"] = near_ties(cell, texts)
    return r


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("gpubench.fp8_control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--call-size", type=int, default=16)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench, reg = load_benchmark(), Registry()
    for seed in args.seeds:
        t0 = time.monotonic()
        r = control(bench, args.workload, seed, args.seconds,
                    args.call_size, "cuda", reg)
        notes = r["notes"]
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "reading": "control_fp8_reference", "correct": r["correct"],
            "checks": r["checks"], "emb_gap_max": notes["emb_gap_max"],
            "emb_gap_median": notes.get("emb_gap_median"),
            "compared": notes["compared"], "calls": notes["calls"],
            "call_size": args.call_size, "near_ties": r["near_ties"],
            "card": run.card_line(),
            "seconds": time.monotonic() - t0}), flush=True)


if __name__ == "__main__":
    main()

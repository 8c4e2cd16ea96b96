"""Readings that a cell's correctness limit is set from (run on the card).

    python3 -m gpubench.calibrate --workload <cell> --seconds 5 \\
        --seeds <n> ... --control-seeds <n> ...

For each of ``--seeds`` it runs the cell as a run does (the timed path,
its sample, the plain reference) and prints the program's widest L2 gap
(the lower reading's material). For each of ``--control-seeds`` it prints
two controls at the cell's own size and load: the program with its own
lower-precision path switched on (``int8_eval``: W8A8 int8 products for
every batch, the step below bfloat16), and the reference computed in
float8 e4m3 put in the program's place (the gap between the fp8 and the
f32 reference on the same sample). One JSON line each, on standard
output; every engine of one process shares the kernels built once.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from . import run
from .registry import Registry, load_benchmark

INT8 = {"int8_eval": True, "int8_threshold": 0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("gpubench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    bench, reg = load_benchmark(), Registry()

    def once(seed, **kw):
        r = run.execute(bench, args.workload, seed, args.seconds, False,
                        "cuda", reg, time.monotonic(), **kw)
        return r, r["notes"]

    for seed in args.seeds:
        r, notes = once(seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": "program", "correct": r["correct"],
                          "emb_gap_max": notes["emb_gap_max"],
                          "emb_gap_median": notes.get("emb_gap_median"),
                          "compared": notes["compared"],
                          "metrics": r["metrics"]}), flush=True)
    for seed in args.control_seeds:
        r, notes = once(seed, engine_overrides=INT8, keep_answers=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": "control_int8_eval",
                          "emb_gap_max": notes["emb_gap_max"],
                          "emb_gap_median": notes.get("emb_gap_median"),
                          "compared": notes["compared"]}), flush=True)
        cell = run.make_cell(bench, args.workload, seed, args.seconds, False,
                             "cuda", reg, time.monotonic())
        texts = [t for t, _ in r["answers"]]
        f32 = run.reference_embeddings(cell, texts)
        fp8 = run.reference_embeddings(cell, texts, precision="fp8")
        gaps = np.linalg.norm(fp8 - f32, axis=1)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": "control_fp8_reference",
                          "emb_gap_max": float(gaps.max()),
                          "emb_gap_median": float(np.median(gaps)),
                          "compared": len(texts)}), flush=True)


if __name__ == "__main__":
    main()

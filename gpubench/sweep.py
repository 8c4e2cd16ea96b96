"""The knee of a serving cell (run on the card): one engine, the cell's
open loop at each offered rate in turn.

    python3 -m gpubench.sweep --workload <cell> --seed <n> --seconds 8 \\
        --rates 1000 2000 ...

One JSON line a rate: p50 and p95 latency over every request due in the
window (from when it was due), the share of them answered inside the
window, the failures, and how late the generator sent. The knee is the
highest offered rate at which at least 99% of the requests due in the
window are answered in it and p95 stays under the mix's limit; the cell
offers 4/5 of it (the mix's ``rate_per_s``, with the table in its
``knee``).
"""

from __future__ import annotations

import argparse
import json
import time

from . import run
from .registry import Registry, load_benchmark


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("gpubench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--grace", type=float, default=20.0)
    ap.add_argument("--stop-below", type=float, default=0.9,
                    help="stop once fewer than this share of a window's "
                    "requests are answered inside it")
    args = ap.parse_args(argv)
    bench, reg = load_benchmark(), Registry()
    cell = run.make_cell(bench, args.workload, args.seed, args.seconds,
                         False, "cuda", reg, time.monotonic())
    engine = run.build_engine(cell)
    for rate in args.rates:
        r = run.execute(bench, args.workload, args.seed, args.seconds, False,
                        "cuda", reg, time.monotonic(), engine=engine,
                        mix_overrides={"rate_per_s": rate,
                                       "grace_s": args.grace})
        n = r["notes"]
        print(json.dumps({
            "workload": args.workload, "rate_per_s": rate,
            "p50_ms": r["metrics"]["latency_p50_ms"]["value"],
            "p95_ms": r["metrics"]["latency_p95_ms"]["value"],
            "done_in_window": n["done_in_window"],
            "attempted": r["attempted"], "failed": r["failed"],
            "send_late_p99_ms": n["send_late_p99_ms"],
            "correct": r["correct"]}), flush=True)
        if n["done_in_window"] < args.stop_below:
            break


if __name__ == "__main__":
    main()

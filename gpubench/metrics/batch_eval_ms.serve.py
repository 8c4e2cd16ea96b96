"""Mean evaluation time of a scheduler batch (tokenize, the engine, the
copy to the host): ``t_eval1 - t_eval0`` of the server's per-batch trace,
over the batches collected in the window."""

UNIT = "ms"
SOURCE = "program_span"
MOVES = "latency_p50_ms"


def read(ctx):
    rows = [r for r in ctx.get("sched_trace") or ()
            if "t_eval0" in r and "t_eval1" in r]
    if not rows:
        return None
    return 1e3 * sum(r["t_eval1"] - r["t_eval0"] for r in rows) / len(rows)

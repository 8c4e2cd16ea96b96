"""Mean wait of a batch in the scheduler: from its first request's
collection to the start of its evaluation (``t_eval0 - t_first`` of the
server's per-batch trace, ``BERT_TPU_SCHED_TRACE``), over the batches
collected in the window."""

UNIT = "ms"
SOURCE = "program_span"
MOVES = "latency_p95_ms"


def read(ctx):
    rows = [r for r in ctx.get("sched_trace") or ()
            if "t_first" in r and "t_eval0" in r]
    if not rows:
        return None
    return 1e3 * sum(r["t_eval0"] - r["t_first"] for r in rows) / len(rows)

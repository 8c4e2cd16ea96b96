"""Requests a scheduler batch carried over the window: the change in the
server's STATS counters, ``n_served`` over ``n_batches``."""

UNIT = "requests/batch"
SOURCE = "program_counter"
MOVES = "latency_p95_ms"


def read(ctx):
    s0, s1 = ctx.get("sched_stats0"), ctx.get("sched_stats1")
    if s0 is None or s1 is None or s1[1] <= s0[1]:
        return None
    return (s1[0] - s0[0]) / (s1[1] - s0[1])

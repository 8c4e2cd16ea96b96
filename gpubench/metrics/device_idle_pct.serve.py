"""The device's idle share of the traced window (serve cells)."""

from gpubench.readers import idle_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "latency_p50_ms"


def read(ctx):
    return idle_pct(ctx)

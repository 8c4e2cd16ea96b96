"""The device's idle share of the traced window (passage cells)."""

from gpubench.readers import idle_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "passages_per_s"


def read(ctx):
    return idle_pct(ctx)

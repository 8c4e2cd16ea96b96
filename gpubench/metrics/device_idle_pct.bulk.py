"""The device's idle share of the traced window (bulk cells)."""

from gpubench.readers import idle_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "sentences_per_s"


def read(ctx):
    return idle_pct(ctx)

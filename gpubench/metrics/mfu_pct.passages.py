"""``mfu_pct.bulk`` in the passage cells."""

from gpubench.readers import mfu_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "passages_per_s"


def read(ctx):
    return mfu_pct(ctx)

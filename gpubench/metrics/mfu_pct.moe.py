"""``moe_readers.mfu_pct`` in the DeepSeek-V2 cells."""

from gpubench.moe_readers import mfu_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "passages_per_s"


def read(ctx):
    return mfu_pct(ctx)

"""The model's FLOPs on the real tokens of the traced window over the
window times the bf16 peak (``readers.mfu_pct``), in the sentence cells."""

from gpubench.readers import mfu_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "sentences_per_s"


def read(ctx):
    return mfu_pct(ctx)

"""``doc_readers.mfu_pct`` in the ModernBERT document cells."""

from gpubench.doc_readers import mfu_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "passages_per_s"


def read(ctx):
    return mfu_pct(ctx)

"""The band attention's share of its roofline in the ModernBERT document
cells (``doc_readers.attention_roofline_pct``)."""

from gpubench.doc_readers import attention_roofline_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "passages_per_s"


def read(ctx):
    return attention_roofline_pct(ctx, "band")

"""``doc_readers.q4_matmul_roofline_pct`` in the ModernBERT document cells."""

from gpubench.doc_readers import q4_matmul_roofline_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "passages_per_s"


def read(ctx):
    return q4_matmul_roofline_pct(ctx)

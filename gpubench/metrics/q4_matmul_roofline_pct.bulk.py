"""q4_matmul's share of its roofline over the traced window
(``readers.q4_matmul_roofline_pct``), in the sentence cells."""

from gpubench.readers import q4_matmul_roofline_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "sentences_per_s"


def read(ctx):
    return q4_matmul_roofline_pct(ctx)

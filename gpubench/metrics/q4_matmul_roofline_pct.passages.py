"""``q4_matmul_roofline_pct.bulk`` in the passage cells."""

from gpubench.readers import q4_matmul_roofline_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "passages_per_s"


def read(ctx):
    return q4_matmul_roofline_pct(ctx)

"""The dense Q4 products' share of their roofline in the DeepSeek-V2 cells
(``moe_readers.q4_matmul_roofline_pct``)."""

from gpubench.moe_readers import q4_matmul_roofline_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "passages_per_s"


def read(ctx):
    return q4_matmul_roofline_pct(ctx)

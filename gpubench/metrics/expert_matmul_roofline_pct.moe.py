"""The grouped expert product's share of its roofline in the DeepSeek-V2
cells (``moe_readers.expert_matmul_roofline_pct``)."""

from gpubench.moe_readers import expert_matmul_roofline_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "passages_per_s"


def read(ctx):
    return expert_matmul_roofline_pct(ctx)

"""The causal latent attention's share of its roofline in the DeepSeek-V2
cells (``moe_readers.mla_attention_roofline_pct``)."""

from gpubench.moe_readers import mla_attention_roofline_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "passages_per_s"


def read(ctx):
    return mla_attention_roofline_pct(ctx)

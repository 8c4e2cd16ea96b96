"""The card idle while the port's host path held it, as a share of the
traced window (``spans.host_idle_pct``), in the sentence cells."""

from gpubench.spans import host_idle_pct

UNIT = "%"
SOURCE = "device_trace"
MOVES = "sentences_per_s"


def read(ctx):
    return host_idle_pct(ctx)

"""What the program's own spans say on the device trace.

The port times its host path in phases (``bert_tpu_torch.profiling.
PhaseTimers``: tokenize, route, dispatch and its parts, gather and its
parts), and while a ``torch.profiler`` records, each phase is a span named
``bert_tpu_torch.<phase>`` on the trace's clock. ``tracing._name_gaps``
names each idle gap of the card after the innermost host event over its
middle, so a gap inside a phase and outside any torch op or CUDA call
carries the phase's name. A program without such spans leaves them out.
"""

# the port's profiling.SPAN_PREFIX, written out: a program that predates it
# is read too
PROGRAM_SPAN = "bert_tpu_torch."


def records_spans(ctx):
    """Whether the program puts its phases on the trace: the port that
    does times a ``route`` phase, which no earlier port has."""
    stats = ctx.get("stats1")
    return stats is not None and "route" in stats["phases"]


def host_idle_pct(ctx):
    """The card's idle seconds in the traced window that a span of the
    program names, over the window, in percent: the card idle while the
    port's host path held it. 0 where the program records spans and no
    gap carries their name; None without a device trace or device
    activity, and where the program records no spans."""
    trace = ctx.get("trace")
    if trace is None or trace["busy_s"] <= 0:
        return None
    named = [s for name, s in trace["idle_gaps"].items()
             if name.startswith(PROGRAM_SPAN)]
    if not named and not records_spans(ctx):
        return None
    return 100.0 * sum(named) / trace["window_s"]

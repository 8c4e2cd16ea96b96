"""Arithmetic of the per-layer readers of the ModernBERT document cells
(metrics/*.docs.py): the model's FLOPs (``costs.modernbert``), its Q4
products and its two attention forms (``costs.attention``) against the
traced window. Each reader returns None where what it reads is missing (a
program without the counters it reads) or where the trace's launches
differ from the work it counted, since the time could then not be matched
to the work."""

from gpubench import peaks
from gpubench.costs import attention, modernbert, q4_matmul

Q4_KERNEL = "q4_matmul"
# the fused attention's forms, by the names of their kernels: the band
# kernel, and every other fused attention kernel for the full form (RoPE
# runs before either, in a kernel of its own that neither counts)
ATTENTION_KERNEL = "fused_attention_"
BAND_KERNEL = "fused_attention_band"


def _delta(ctx, key):
    """The window's counts of ``stats()[key]``: name → launches."""
    s0, s1 = ctx.get("stats0"), ctx.get("stats1")
    if s0 is None or s1 is None or key not in s1:
        return None
    return {k: n - s0.get(key, {}).get(k, 0) for k, n in s1[key].items()
            if n - s0.get(key, {}).get(k, 0) > 0}


def _kernel_time(trace, name, without=None):
    """Seconds and launches of the trace's kernels whose names hold
    ``name`` (and not ``without``)."""
    names = [k for k in trace["kernels"] if name in k
             and (without is None or without not in k)]
    return (sum(trace["kernels"][k] for k in names),
            sum(trace["launches"][k] for k in names))


def mfu_pct(ctx):
    """The model's FLOPs on the real tokens the traced window completed
    (``costs.modernbert``: each token at its own sequence's length), over
    the window's wall time times the card's bf16 peak, in percent."""
    trace, cfg, lengths = ctx.get("trace"), ctx.get("cfg"), ctx.get(
        "lengths")
    if trace is None or trace["busy_s"] <= 0 or lengths is None or not len(
            lengths):
        return None
    return 100.0 * modernbert.flops(lengths, cfg) / (
        ctx["window_s"] * peaks.BF16_FLOPS)


def q4_matmul_roofline_pct(ctx):
    """q4_matmul's share of its roofline: the least time of ModernBERT's
    four Q4 products a layer at M = rows x T of each batch
    (``stats()["buckets"]``, for the M the router sends to a kernel) over
    the device time of the trace's ``q4_matmul`` kernels, in percent."""
    trace, buckets = ctx.get("trace"), _delta(ctx, "buckets")
    if trace is None or buckets is None:
        return None
    cfg = ctx["cfg"]
    products = modernbert.layer_products(cfg["hidden_size"],
                                         cfg["intermediate_size"])
    layers = cfg["num_hidden_layers"]
    least, launches = 0.0, 0
    for key, n in buckets.items():
        rows, seq = (int(v) for v in key.split()[0].split("x"))
        m = rows * seq
        if m > ctx["q4_fused_max_m"]:
            continue
        least += n * layers * sum(
            q4_matmul.least_seconds(m, k, nn, ctx["act_bytes"])
            for k, nn in products)
        launches += n * layers * len(products)
    seconds, traced = _kernel_time(trace, Q4_KERNEL)
    if not launches or seconds <= 0 or launches != traced:
        return None
    return 100.0 * least / seconds


def attention_roofline_pct(ctx, kind):
    """The ``kind`` ("full" or "band") attention's share of its roofline:
    the least time of the launches ``stats()["attention"]`` counted
    (``costs.attention`` at each launch's rows and T; the band's
    half-width local_attention / 2) over the device time of the trace's
    kernels of that form, in percent."""
    trace, counts = ctx.get("trace"), _delta(ctx, "attention")
    if trace is None or counts is None:
        return None
    cfg = ctx["cfg"]
    h = cfg["num_attention_heads"]
    dh = cfg["hidden_size"] // h
    window = cfg["local_attention"] // 2 if kind == "band" else 0
    least, launches = 0.0, 0
    for key, n in counts.items():
        k, shape = key.split()
        if k != kind:
            continue
        rows, seq = (int(v) for v in shape.split("x"))
        least += n * attention.least_seconds(rows, seq, h, dh, window,
                                             ctx["act_bytes"])
        launches += n
    seconds, traced = (_kernel_time(trace, BAND_KERNEL) if kind == "band"
                       else _kernel_time(trace, ATTENTION_KERNEL,
                                         BAND_KERNEL))
    if not launches or seconds <= 0 or launches != traced:
        return None
    return 100.0 * least / seconds

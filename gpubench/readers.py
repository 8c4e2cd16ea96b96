"""Arithmetic shared by the per-layer metric readers (metrics/*.py): the
quantities that cells of different end-to-end metrics report under names
of their own."""

from gpubench import peaks
from gpubench.costs import encoder, q4_matmul

Q4_KERNEL = "q4_matmul"


def us_per_text(ctx, phase):
    s0, s1 = ctx.get("stats0"), ctx.get("stats1")
    if s0 is None or s1 is None:
        return None
    n = s1["sentences"] - s0["sentences"]
    p0 = s0["phases"].get(phase, {}).get("total_s", 0.0)
    p1 = s1["phases"].get(phase, {}).get("total_s")
    if n <= 0 or p1 is None:
        return None
    return 1e6 * (p1 - p0) / n


def idle_pct(ctx):
    trace = ctx.get("trace")
    if trace is None or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def mfu_pct(ctx):
    """The model's FLOPs on the real tokens the traced window completed
    (``costs.encoder``: each token at its own sequence's length), over the
    window's wall times the card's bf16 peak, in percent."""
    trace, cfg, lengths = ctx.get("trace"), ctx.get("cfg"), ctx.get(
        "lengths")
    if trace is None or trace["busy_s"] <= 0 or lengths is None or not len(
            lengths):
        return None
    flops = encoder.flops(lengths, cfg["hidden_size"],
                          cfg["intermediate_size"],
                          cfg["num_hidden_layers"])
    return 100.0 * flops / (ctx["window_s"] * peaks.BF16_FLOPS)


def q4_matmul_roofline_pct(ctx):
    """q4_matmul's share of its roofline over the traced window: the least
    time of the Q4 products it computed (``costs.q4_matmul``, four a layer
    at M = rows x T of each batch from the engine's bucket counters, for
    the batches whose M the router sends to the kernel) over the device
    time of the trace's ``q4_matmul`` kernels, in percent. Nothing is read
    where the trace's launches differ from the count the buckets give,
    since the time could then not be matched to the work."""
    trace, s0, s1 = ctx.get("trace"), ctx.get("stats0"), ctx.get("stats1")
    if trace is None or s0 is None or s1 is None:
        return None
    cfg = ctx["cfg"]
    products = q4_matmul.layer_products(cfg["hidden_size"],
                                        cfg["intermediate_size"])
    layers = cfg["num_hidden_layers"]
    least, launches = 0.0, 0
    for key, n1 in s1["buckets"].items():
        n = n1 - s0["buckets"].get(key, 0)
        rows, seq = (int(v) for v in key.split()[0].split("x"))
        m = rows * seq
        if n <= 0 or m > ctx["q4_fused_max_m"]:
            continue
        least += n * layers * sum(
            q4_matmul.least_seconds(m, k, nn, ctx["act_bytes"])
            for k, nn in products)
        launches += n * layers * len(products)
    names = [k for k in trace["kernels"] if Q4_KERNEL in k]
    seconds = sum(trace["kernels"][k] for k in names)
    if not launches or seconds <= 0 or launches != sum(
            trace["launches"][k] for k in names):
        return None
    return 100.0 * least / seconds

"""Arithmetic of the per-layer readers of the DeepSeek-V2 cells
(metrics/*.moe.py): the model's FLOPs (``costs.deepseek_v2``), its grouped
expert products, its dense Q4 products and its causal attention against
the traced window. Each reader returns None where what it reads is
missing (a program without the counters or kernels it reads) or where the
trace's launches differ from the work it counted, since the time could
then not be matched to the work."""

from gpubench import peaks
from gpubench.costs import deepseek_v2, q4_matmul
from gpubench.doc_readers import _delta, _kernel_time

Q4_KERNEL = "q4_matmul"
EXPERT_KERNEL = "expert_matmul_kernel"
ATTENTION_KERNEL = "causal_mla_kernel"


def _batches(ctx):
    """(n, rows, T) of each batch shape the window launched."""
    buckets = _delta(ctx, "buckets")
    if buckets is None:
        return None
    return [(n, *(int(v) for v in key.split()[0].split("x")))
            for key, n in buckets.items()]


def mfu_pct(ctx):
    """The model's FLOPs on the real tokens the traced window completed
    (``costs.deepseek_v2``: each token at its own sequence's length), over
    the window's wall time times the card's bf16 peak, in percent."""
    trace, cfg, lengths = ctx.get("trace"), ctx.get("cfg"), ctx.get(
        "lengths")
    if trace is None or trace["busy_s"] <= 0 or lengths is None or not len(
            lengths):
        return None
    return 100.0 * deepseek_v2.flops(lengths, cfg) / (
        ctx["window_s"] * peaks.BF16_FLOPS)


def expert_matmul_roofline_pct(ctx):
    """The grouped expert product's share of its roofline: the least time
    of each MoE layer's two grouped products at M = rows x T launched
    tokens (``stats()["buckets"]``) over the device time of the trace's
    grouped-product kernels, in percent."""
    trace, batches = ctx.get("trace"), _batches(ctx)
    if trace is None or batches is None:
        return None
    cfg = ctx["cfg"]
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    least, launches = 0.0, 0
    for n, rows, seq in batches:
        least += n * moe_layers * deepseek_v2.expert_least_seconds(
            rows * seq, cfg, ctx["act_bytes"])
        launches += n * moe_layers * 2
    seconds, traced = _kernel_time(trace, EXPERT_KERNEL)
    if not launches or seconds <= 0 or launches != traced:
        return None
    return 100.0 * least / seconds


def q4_matmul_roofline_pct(ctx):
    """q4_matmul's share of its roofline in the DeepSeek-V2 cells: the
    least time of the dense Q4 products (q, kv_a, kv_b, o in every layer;
    the dense layer's SwiGLU, the shared experts' in the MoE layers) at M
    = rows x T of each batch over the device time of the trace's
    ``q4_matmul`` kernels (the grouped product's are not among them), in
    percent."""
    trace, batches = ctx.get("trace"), _batches(ctx)
    if trace is None or batches is None:
        return None
    cfg = ctx["cfg"]
    layers, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    att = deepseek_v2.attention_products(cfg)
    products = ([att + deepseek_v2.mlp_products(cfg, False)] * dense
                + [att + deepseek_v2.mlp_products(cfg, True)]
                * (layers - dense))
    least, launches = 0.0, 0
    for n, rows, seq in batches:
        m = rows * seq
        if m > ctx["q4_fused_max_m"]:
            continue
        for layer in products:
            least += n * sum(q4_matmul.least_seconds(m, k, nn,
                                                     ctx["act_bytes"])
                             for k, nn in layer)
            launches += n * len(layer)
    seconds, traced = _kernel_time(trace, Q4_KERNEL, EXPERT_KERNEL)
    if not launches or seconds <= 0 or launches != traced:
        return None
    return 100.0 * least / seconds


def mla_attention_roofline_pct(ctx):
    """The causal latent attention's share of its roofline: the least time
    of the launches ``stats()["attention"]`` counted (kind "causal",
    ``costs.deepseek_v2`` at each launch's rows and T) over the device time
    of the trace's causal attention kernels (the RoPE pass is not among
    them), in percent."""
    trace, counts = ctx.get("trace"), _delta(ctx, "attention")
    if trace is None or counts is None:
        return None
    cfg = ctx["cfg"]
    least, launches = 0.0, 0
    for key, n in counts.items():
        kind, shape = key.split()
        if kind != "causal":
            continue
        rows, seq = (int(v) for v in shape.split("x"))
        least += n * deepseek_v2.attention_least_seconds(rows, seq, cfg,
                                                         ctx["act_bytes"])
        launches += n
    seconds, traced = _kernel_time(trace, ATTENTION_KERNEL)
    if not launches or seconds <= 0 or launches != traced:
        return None
    return 100.0 * least / seconds

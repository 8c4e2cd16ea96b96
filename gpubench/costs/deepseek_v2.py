"""Model FLOPs of DeepSeek-V2 as an embedding backbone, counted on real
tokens, and the shapes of its products and of its causal attention.

A token touches, in each layer, the attention's four projections (q:
D·H·192, kv_a: D·(512 + 64), kv_b: 512·H·256, o: H·128·D) and, in a dense
layer, its SwiGLU (3·D·F), in a MoE layer the router (D·E), its k routed
experts and its shared ones (3·D·F_e each): 2 operations a weight. Each
(query, key) pair the causal mask admits costs 2·H·(192 + 128): q·k over
192 lanes and p·v over 128, a multiply and an add each. A sequence of t
real tokens has t·(t + 1)/2 such pairs a layer."""

from .. import peaks
from . import q4_matmul

Q4_0_BYTES_PER_WEIGHT = q4_matmul.Q4_0_BYTES_PER_WEIGHT


def dims(cfg: dict) -> dict:
    return {"d": cfg["hidden_size"], "h": cfg["num_attention_heads"],
            "nope": cfg["qk_nope_head_dim"], "rope": cfg["qk_rope_head_dim"],
            "dv": cfg["v_head_dim"], "rank": cfg["kv_lora_rank"],
            "f": cfg["intermediate_size"],
            "fe": cfg["moe_intermediate_size"],
            "e": cfg["n_routed_experts"], "k": cfg["num_experts_per_tok"],
            "shared": cfg.get("n_shared_experts") or 0,
            "layers": cfg["num_hidden_layers"],
            "dense": cfg["first_k_dense_replace"]}


def attention_products(cfg: dict):
    """The (K, N) of one layer's four attention products: q, kv_a, kv_b,
    o."""
    x = dims(cfg)
    return ((x["d"], x["h"] * (x["nope"] + x["rope"])),
            (x["d"], x["rank"] + x["rope"]),
            (x["rank"], x["h"] * (x["nope"] + x["dv"])),
            (x["h"] * x["dv"], x["d"]))


def mlp_products(cfg: dict, moe: bool):
    """The (K, N) of the dense products of a layer's MLP as the program
    runs them: the gate and up product (one, N = 2·width) and the down
    product, of the dense SwiGLU or of the shared experts."""
    x = dims(cfg)
    width = x["shared"] * x["fe"] if moe else x["f"]
    if not width:
        return ()
    return ((x["d"], 2 * width), (width, x["d"]))


def expert_products(cfg: dict):
    """The (K, N) of the grouped expert products, as launched: gate and up
    (N = 2·F_e, of which SwiGLU writes F_e) and down."""
    x = dims(cfg)
    return ((x["d"], 2 * x["fe"]), (x["fe"], x["d"]))


def weights_per_token(cfg: dict) -> int:
    """Weights of the products a token goes through, over all layers."""
    x = dims(cfg)
    att = sum(k * n for k, n in attention_products(cfg))
    dense = 3 * x["d"] * x["f"]
    moe = (x["d"] * x["e"] + 3 * x["d"] * x["fe"] * (x["k"] + x["shared"]))
    return (x["layers"] * att + x["dense"] * dense
            + (x["layers"] - x["dense"]) * moe)


def pair_flops(cfg: dict) -> float:
    x = dims(cfg)
    return 2.0 * x["h"] * (x["nope"] + x["rope"] + x["dv"])


def pairs(t: int) -> int:
    """(query, key) pairs of a row of ``t`` that the causal mask admits."""
    return t * (t + 1) // 2


def flops(lengths, cfg: dict) -> float:
    """Sum over sequences of real-token lengths ``lengths``."""
    n = sum(int(t) for t in lengths)
    p = sum(pairs(int(t)) for t in lengths)
    return (2.0 * weights_per_token(cfg) * n
            + pair_flops(cfg) * dims(cfg)["layers"] * p)


def expert_least_seconds(m: int, cfg: dict, act_bytes: int = 2) -> float:
    """The least time of one MoE layer's grouped products over M launched
    tokens (k·M sorted rows): 2·(k·M)·K·N operations each; bytes: all E
    experts' Q4_0 weights, the gathered rows read and the output written
    in the compute dtype (gate and up writes F_e columns). Each product
    bound on its own, summed."""
    x = dims(cfg)
    rows = x["k"] * m
    total = 0.0
    for i, (k, n) in enumerate(expert_products(cfg)):
        out = n // 2 if i == 0 else n
        ops = 2.0 * rows * k * n
        nbytes = (x["e"] * k * n * Q4_0_BYTES_PER_WEIGHT
                  + act_bytes * rows * (k + out))
        total += max(ops / peaks.BF16_FLOPS,
                     nbytes / peaks.HBM_BYTES_PER_S)
    return total


def attention_least_seconds(b: int, t: int, cfg: dict,
                            act_bytes: int = 2) -> float:
    """The least time of one causal attention launch over B rows of T:
    operations over the admitted pairs at the launched T; bytes: q, k_nope,
    kr and v read once and the context written once (v counted at its 128
    lanes)."""
    x = dims(cfg)
    ops = pair_flops(cfg) * b * pairs(t)
    nbytes = act_bytes * b * t * (x["h"] * (x["nope"] + x["rope"])
                                  + x["h"] * x["nope"] + x["rope"]
                                  + 2 * x["h"] * x["dv"])
    return max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)

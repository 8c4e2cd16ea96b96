"""Model FLOPs of a ModernBERT encoder, counted on real tokens, and the
(K, N) of its Q4 products.

A token of a sequence of ``t`` real tokens costs, in each of the L layers,
2·(3·D² + D² + 2·D·I + I·D) in the four projections (Wqkv, Wo, Wi of
GeGLU's input and gate, mlp.Wo; I the GeGLU width) and 4·D times the keys
it attends to: all ``t`` in a global layer, those within ±local/2 of it
in a local one (clipped at the sequence's ends). Summed over a sequence,
the keys are ``costs.attention.pairs(t, w)``."""

from . import attention


def layer_products(d: int, i: int):
    """The (K, N) of one layer's four Q4 products: Wqkv, Wo, Wi (input and
    gate), mlp.Wo."""
    return ((d, 3 * d), (d, d), (d, 2 * i), (i, d))


def n_global(cfg: dict) -> int:
    every = cfg["global_attn_every_n_layers"]
    return sum(1 for layer in range(cfg["num_hidden_layers"])
               if layer % every == 0)


def flops_per_sequence(t: int, cfg: dict) -> float:
    d, i = cfg["hidden_size"], cfg["intermediate_size"]
    layers = cfg["num_hidden_layers"]
    g = n_global(cfg)
    w = cfg["local_attention"] // 2
    dense = 2.0 * layers * sum(k * n for k, n in layer_products(d, i))
    return (dense * t + 4.0 * d * g * attention.pairs(t)
            + 4.0 * d * (layers - g) * attention.pairs(t, w))


def flops(lengths, cfg: dict) -> float:
    """Sum over sequences of real-token lengths ``lengths``."""
    return sum(flops_per_sequence(int(t), cfg) for t in lengths)

"""``x[M, K] @ dequant(W)[K, N]`` with W in Q4_0.

Operations: 2·M·K·N. Bytes: x read once and the output written once, both
in the compute dtype, and W read once at Q4_0's 18 bytes per 32 weights
(16 bytes of nibbles and an f16 scale), whatever a given implementation
stores or re-reads."""

from .. import peaks

Q4_0_BYTES_PER_WEIGHT = 18 / 32


def ops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def nbytes(m: int, k: int, n: int, act_bytes: int = 2) -> float:
    return act_bytes * (m * k + m * n) + k * n * Q4_0_BYTES_PER_WEIGHT


def least_seconds(m: int, k: int, n: int, act_bytes: int = 2) -> float:
    """The least time the card needs: the larger of the operations over
    the bf16 peak and the bytes over the HBM rate."""
    return max(ops(m, k, n) / peaks.BF16_FLOPS,
               nbytes(m, k, n, act_bytes) / peaks.HBM_BYTES_PER_S)


def layer_products(d: int, f: int):
    """The (K, N) of one BERT layer's four Q4 products: fused QKV,
    attention output, FFN up, FFN down."""
    return ((d, 3 * d), (d, d), (d, f), (f, d))

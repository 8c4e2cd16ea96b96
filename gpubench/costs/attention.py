"""Operations and bytes of one attention launch over a head-interleaved
QKV batch of B rows of T tokens (H heads of dh), full or in a band of
half-width w (|i - j| <= w), whatever implements it.

Operations: 4·B·H·dh for each (query, key) pair the structural mask admits
at the launched T (q·kᵀ and p·v, a multiply and an add each): T² pairs a
row in full, T·(2w + 1) − w·(w + 1) in the band (fewer near the ends,
where the band is clipped). Padding keys are not taken out: the launch
computes them. Bytes: q, k and v read once and the context written once,
4·B·T·H·dh elements in the compute dtype."""

from .. import peaks


def pairs(t: int, window: int = 0) -> int:
    """(query, key) pairs of one row of ``t``: every pair where ``window``
    is 0, else those with |i - j| <= window."""
    if window <= 0 or t <= window + 1:
        return t * t
    return t * (2 * window + 1) - window * (window + 1)


def ops(b: int, t: int, h: int, dh: int, window: int = 0) -> float:
    return 4.0 * b * h * dh * pairs(t, window)


def nbytes(b: int, t: int, h: int, dh: int, act_bytes: int = 2) -> float:
    return 4.0 * b * t * h * dh * act_bytes


def least_seconds(b: int, t: int, h: int, dh: int, window: int = 0,
                  act_bytes: int = 2) -> float:
    """The least time the card needs: the larger of the operations over
    the bf16 peak and the bytes over the HBM rate."""
    return max(ops(b, t, h, dh, window) / peaks.BF16_FLOPS,
               nbytes(b, t, h, dh, act_bytes) / peaks.HBM_BYTES_PER_S)

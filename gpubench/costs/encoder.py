"""Model FLOPs of a BERT encoder, counted on real tokens.

A token of a sequence of ``t`` real tokens costs 2·L·(4·D² + 2·D·F) in
the four projections and 4·L·D·t in attention (scores and context over
its own sequence, not its padded bucket)."""


def flops_per_sequence(t: int, d: int, f: int, layers: int) -> float:
    return t * (2.0 * layers * (4 * d * d + 2 * d * f)
                + 4.0 * layers * d * t)


def flops(lengths, d: int, f: int, layers: int) -> float:
    """Sum over sequences of real-token lengths ``lengths``."""
    dense = 2.0 * layers * (4 * d * d + 2 * d * f)
    n = sum(int(t) for t in lengths)
    sq = sum(int(t) * int(t) for t in lengths)
    return dense * n + 4.0 * layers * d * sq

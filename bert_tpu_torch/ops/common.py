"""Shared kernel-side constants and helpers (single source of truth).

Counterpart of ``bert_tpu/ops/common.py``. ``f32_precision`` has no
counterpart here: the H100 form of the same trap (float32 products silently
run at reduced precision) is TF32, which the package switches off globally
in ``bert_tpu_torch/__init__.py``.
"""

# Additive mask value standing in for -inf. Finite on purpose: fully-masked
# (padding) rows then softmax to a uniform distribution instead of NaN, and
# their outputs are discarded by pooling. Every kernel and every plain
# version uses this one value; none substitutes -inf.
NEG_INF = -1e9


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m

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


# Every kernel launch counter of the op layer: each wrapper that launches a
# kernel, and each instance or form of one counted apart (a :class:`Count`).
# Each is registered where it is defined, so the list is complete once
# ``bert_tpu_torch.ops`` is imported (its ``__init__`` imports every wrapper
# module). A CUDA graph's replay adds what its capture counted
# (``_graphs.py``).
COUNTERS: list = []


def counted(counter):
    """Register ``counter`` in :data:`COUNTERS` with ``launches`` at 0 and
    return it: a wrapper's decorator, or ``counted(Count(name))``."""
    counter.launches = 0
    COUNTERS.append(counter)
    return counter


class Count:
    """The launches of one instance or form of a kernel, kept as a wrapper
    keeps its own (``.launches``)."""

    def __init__(self, name: str):
        self.__name__ = name

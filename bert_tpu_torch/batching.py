"""Length-bucketed batching for variable-length sentences.

The reference sorts inputs by token length and then runs them one at a time
anyway (bert.cpp:1002-1003, n_batch_size forced to 1 at :961). The engine
replaces this with bucketing: sequences are padded up to a small set of fixed
(B, T) shapes. Counterpart of ``bert_tpu/batching.py``, unchanged, so that
both packages route the same inputs into the same batches.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from .ops.common import round_up as _round_up


def size_bucket(n: int, minimum: int = 8) -> int:
    """Shape-bucket a row count: plain powers of two up to 64 (few shapes —
    online serving sees small, varied batches and a recompile costs far
    more than a few padded rows), eighth-of-pow2 steps above (≤12.5 %
    padding where absolute waste matters, 8 sizes per octave).

    ``minimum`` must be a power of two; every returned size is then a
    multiple of it (the engine passes the DP degree so batches shard
    evenly over the data axis — pow2-ness is validated at engine init)."""
    n = max(n, minimum)
    p = 1 << (n - 1).bit_length()  # next power of two ≥ n
    if n <= 64:
        return p  # pow2 ≥ minimum ⇒ multiple of pow2 minimum
    return _round_up(n, max(p // 8, minimum, 1))


def default_seq_buckets(n_max_tokens: int) -> List[int]:
    """Power-of-two sequence buckets: 16, 32, ... up to n_max_tokens."""
    buckets = []
    b = 16
    while b < n_max_tokens:
        buckets.append(b)
        b *= 2
    buckets.append(n_max_tokens)
    return buckets


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class BucketPlan:
    """Assignment of input indices to padded (batch, seq) buckets."""

    # (seq_bucket, batch_bucket) -> list of index-groups; each group has
    # ≤ batch_bucket entries and is executed as one padded batch.
    groups: List[Tuple[int, int, List[int]]] = field(default_factory=list)


# Extra padded-row-equivalents charged per additional dispatched batch when
# deciding pad-vs-split below: a dispatch costs host work + one more result
# transfer, so tiny padding savings don't justify an extra batch.
_SPLIT_PENALTY_ROWS = 4


@functools.lru_cache(maxsize=4096)
def _tail_sizes(rem: int, max_batch: int, min_batch: int) -> Tuple[int, ...]:
    """Batch buckets for a sub-max_batch remainder, minimizing padded rows
    (+ a small per-batch penalty): either one padded bucket, or the largest
    power of two split off exactly with the rest recursing."""
    bb = min(size_bucket(rem, minimum=min_batch), max_batch)
    if bb == rem:
        return (rem,)
    exact = 1 << (rem.bit_length() - 1)  # largest pow2 ≤ rem
    if exact < min_batch or exact == rem:
        return (bb,)
    tail = _tail_sizes(rem - exact, max_batch, min_batch)
    if exact + sum(tail) + _SPLIT_PENALTY_ROWS < bb:
        return (exact,) + tail
    return (bb,)


def plan_batch_sizes(n: int, max_batch: int, min_batch: int = 1
                     ) -> List[int]:
    """Split ``n`` rows into padded batch buckets with bounded waste.

    Full ``max_batch`` chunks are peeled off first; the remainder is either
    padded to its :func:`size_bucket` or split on exact power-of-two
    boundaries, whichever costs fewer padded rows — e.g. with max_batch=128
    and min_batch=8 a 65-row group runs as 64 + 8(pad from 1) = 72 padded
    rows, not one 128-row batch (with the default min_batch=1 the split is
    64 + 1). Every returned size is a multiple of ``min_batch`` (the DP
    shard divisor) as long as ``min_batch`` is a power of two ≤ max_batch.
    """
    sizes: List[int] = []
    rem = n
    while rem >= max_batch:
        sizes.append(max_batch)
        rem -= max_batch
    if rem:
        sizes.extend(_tail_sizes(rem, max_batch, min_batch))
    return sizes


def plan_buckets(
    lengths: Sequence[int],
    seq_buckets: Sequence[int],
    max_batch: int,
    min_batch: int = 1,
) -> BucketPlan:
    """Group inputs by sequence bucket, then chunk each group into padded
    batch buckets via :func:`plan_batch_sizes` (pow2 ≤ 64 / eighth-of-pow2
    above — the same shape discipline as the packed path) so the set of
    compiled (B, T) shapes stays small without pow2-padding waste on
    awkward group sizes.

    ``min_batch`` forces every batch bucket to a multiple of the DP degree
    so batches shard evenly over the data axis.
    """
    by_bucket: Dict[int, List[int]] = {}
    for idx, n in enumerate(lengths):
        sb = pick_bucket(n, seq_buckets)
        by_bucket.setdefault(sb, []).append(idx)

    plan = BucketPlan()
    for sb in sorted(by_bucket):
        idxs = by_bucket[sb]
        start = 0
        for bb in plan_batch_sizes(len(idxs), max_batch, min_batch):
            chunk = idxs[start : start + bb]
            start += bb
            plan.groups.append((sb, bb, chunk))
    return plan

"""Sequence packing: multiple short sentences per (row, T) with block-diagonal
attention — the second half of the variable-length strategy (SURVEY.md §5.7:
"bucketed padding with explicit attention masks and packed sequences").

Where bucketing pads every sentence up to its bucket length (a 9-token
sentence in a T=16 bucket wastes 7 token slots of work), packing places
several sentences in one row of a fixed (B, T) shape:

  row:  [CLS] a a a [SEP] [CLS] b b b b [SEP] [CLS] c c [SEP] 0 0
  seg:    1   1 1 1   1     2   2 2 2 2   2     3   3 3   3   0 0

and the model (bert_tpu_torch/model.py) makes it exact, not approximate:
  * attention is masked block-diagonally on segment equality, so tokens of
    sentence b never attend to a or c;
  * position embeddings restart at each segment;
  * pooling is a per-segment masked mean + L2 norm.
Packed embeddings therefore equal the unpacked ones to float tolerance.
Counterpart of ``bert_tpu/packing.py``, unchanged.

The planner is greedy first-fit-decreasing over rows of capacity T with at
most S segments per row — ≥90 % token occupancy on natural length mixes vs
~60-75 % for power-of-two bucketing.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class Placement:
    """One sentence's slot in the packed batch."""

    index: int    # position in the caller's token_lists
    row: int
    offset: int   # first token slot in the row
    length: int
    slot: int     # segment number within the row, 0-based (seg id = slot+1)


@dataclass
class PackPlan:
    placements: List[Placement]
    n_rows: int
    seq_len: int
    max_segments: int

    @property
    def occupancy(self) -> float:
        used = sum(p.length for p in self.placements)
        return used / max(self.n_rows * self.seq_len, 1)


def plan_packing(
    lengths: Sequence[int],
    seq_len: int,
    max_segments: int,
) -> PackPlan:
    """Best-fit-decreasing bin packing of sentences into rows.

    Open rows are kept in a capacity-sorted list and picked by bisect, so
    planning is O(n log n · insert) — fast enough to run per encode call on
    thousands of sentences. Rows that fill up (or hit the segment cap)
    leave the open list. Every length must be ≤ seq_len (the caller routes
    longer sentences to the bucketed path).
    """
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    # open rows, sorted by remaining capacity: parallel (capacity, row id)
    open_caps: List[int] = []
    open_rows: List[int] = []
    rows_used: List[int] = []   # tokens used per row (all rows)
    rows_nseg: List[int] = []
    placements: List[Placement] = []
    for i in order:
        ln = lengths[i]
        if ln > seq_len:
            raise ValueError(f"length {ln} exceeds pack seq_len {seq_len}")
        j = bisect.bisect_left(open_caps, ln)  # tightest row that fits
        if j < len(open_caps):
            r = open_rows.pop(j)
            cap = open_caps.pop(j) - ln
        else:
            r = len(rows_used)
            rows_used.append(0)
            rows_nseg.append(0)
            cap = seq_len - ln
        placements.append(Placement(index=i, row=r, offset=rows_used[r],
                                    length=ln, slot=rows_nseg[r]))
        rows_used[r] += ln
        rows_nseg[r] += 1
        if cap > 0 and rows_nseg[r] < max_segments:
            j = bisect.bisect_left(open_caps, cap)
            open_caps.insert(j, cap)
            open_rows.insert(j, r)
    return PackPlan(placements=placements, n_rows=len(rows_used),
                    seq_len=seq_len, max_segments=max_segments)


def pack_batch(
    token_lists: Sequence[Sequence[int]],
    plan: PackPlan,
    *,
    n_rows: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Materialize (ids, segment_ids, position_ids, flat_slot) arrays.

    ``n_rows`` may exceed plan.n_rows (row-count bucketing for compile-shape
    discipline); extra rows are all padding. ``flat_slot[j]`` is the index
    of sentence ``plan.placements[j].index`` in the flattened
    ``[n_rows * max_segments]`` per-segment output — used for the on-device
    gather of valid segment embeddings.
    """
    t, s = plan.seq_len, plan.max_segments
    ids = np.zeros((n_rows, t), dtype=np.int32)
    seg = np.zeros((n_rows, t), dtype=np.int32)
    pos = np.zeros((n_rows, t), dtype=np.int32)
    flat = np.zeros(len(plan.placements), dtype=np.int32)
    for j, p in enumerate(plan.placements):
        toks = token_lists[p.index]
        ids[p.row, p.offset : p.offset + p.length] = toks
        seg[p.row, p.offset : p.offset + p.length] = p.slot + 1
        pos[p.row, p.offset : p.offset + p.length] = np.arange(p.length)
        flat[j] = p.row * s + p.slot
    return ids, seg, pos, flat

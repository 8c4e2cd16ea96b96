"""Comparison rules shared by the port's tests and its card check.

:func:`noise_rule` holds the parameters of two AdamW runs of the same
steps (two devices, or two packages) to each other. The port's CPU tests
hold it against bert_tpu's steps; ``chip_smoke.py`` holds the card
against the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .params import BertConfig

NOISE_REL = 1e-3   # first moments further apart than this, relative: noise
TIGHT_ABS = 1e-6   # what every other element is held to
MAX_NOISE_SHARE = 1e-4  # of a leaf's elements that may be noise


def key_bias_lanes(config: BertConfig) -> np.ndarray:
    """[3·D] bool: the key lanes of the head-interleaved ``qkv_b`` (each
    head's [q | k | v] block of 3·d_head). Their gradient is zero in exact
    arithmetic, since softmax ignores a constant added to every key's
    score of a query, so in floating point it is rounding noise."""
    dh = config.d_head
    return (np.arange(3 * config.n_embd) // dh) % 3 == 1


def noise_rule(got: np.ndarray, want: np.ndarray, mu_got: np.ndarray,
               mu_want: np.ndarray, noisy: np.ndarray, lr: float,
               steps: int, what: str, *,
               exempt: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Hold one leaf's parameters ``got`` to ``want`` after ``steps``
    AdamW steps of two runs.

    Adam's step lr·m̂/(√v̂ + ε) is ≈ lr·sign(g) wherever |g| ≫ ε, so an
    element whose gradient is rounding noise may step either way, up to
    2·lr a step apart. Such an element is one whose first moments in the
    two runs differ by more than ``NOISE_REL`` of it at any step so far
    (``noisy`` accumulates them in place). An element whose gradient is
    zero in both runs has equal moments, so it is not noise: it moves by
    weight decay alone and is held with the rest.

    - every element: |Δ| ≤ 2·lr·steps;
    - ``exempt`` (a mask broadcast over the leaf: lanes whose gradient is
      zero in exact arithmetic, :func:`key_bias_lanes`): nothing more, and
      not counted;
    - every other element: |Δ| ≤ ``TIGHT_ABS`` (a first moment that agrees
      to ``NOISE_REL`` moves Adam's step by about lr·``NOISE_REL``),
      except noisy ones, and of those at most ``MAX_NOISE_SHARE`` of the
      leaf.

    Raises AssertionError naming ``what``; returns the leaf's size, its
    counts of noisy, exempt and beyond-``TIGHT_ABS`` elements (the last
    not exempt), and its largest differences."""
    noisy |= np.abs(mu_got - mu_want) > NOISE_REL * np.abs(mu_want)
    ex = (np.zeros(got.shape, bool) if exempt is None
          else np.broadcast_to(exempt, got.shape))
    d = np.abs(got - want)
    beyond = (d > TIGHT_ABS) & ~ex
    tight = d[~(noisy | ex)]
    out_max = float(tight.max()) if tight.size else 0.0
    n_beyond = int(beyond.sum())
    for ok, msg in (
            (float(d.max()) <= 2 * lr * steps,
             f"max|Δ| {d.max():.3e} > 2·lr·{steps}"),
            (out_max <= TIGHT_ABS,
             f"max|Δ| {out_max:.3e} where the gradient is not noise"),
            (n_beyond <= MAX_NOISE_SHARE * d.size,
             f"{n_beyond} of {d.size} elements beyond {TIGHT_ABS} (noise: "
             f"at most {MAX_NOISE_SHARE} of the leaf)")):
        if not ok:
            raise AssertionError(f"{what}: {msg}")
    return {"size": int(d.size), "noise": int((noisy & ~ex).sum()),
            "exempt": int(ex.sum()), "beyond": n_beyond,
            "max_abs": float(d.max()), "max_abs_outside_noise": out_max,
            "max_abs_exempt": float(d[ex].max()) if ex.any() else 0.0}

"""The one traffic generator: reads a mix's parameters and draws its texts
and arrival times from the seed.

Text sources (the mix's ``texts.source``):

- ``sentences``: one corpus sentence with one corpus word before it and
  one after it. The i-th text of a stream takes sentence i mod n (in an
  order drawn from the seed) and the i-th pair of words of a sequence
  that visits every pair once, so no text repeats within a run (of fewer
  texts than pairs, some 6.4 million).
- ``passages``: corpus sentences drawn from the seed, joined, the last
  cut after as many of its words as make the passage's token count
  ([CLS] and [SEP] included) its target exactly. The targets of a call of
  n passages are the n-point log-uniform grid between ``min_tokens`` and
  ``max_tokens`` in an order drawn from the seed, so every seed's calls
  have the same sizes (the work differs by the words alone). A passage
  that repeats an earlier one is drawn again.

Every text comes with its token count as the model will see it (cut at
the model's positions): the corpus's words are one token each.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from .corpus import Corpus


def rng(seed: int, *key: int) -> np.random.Generator:
    """A generator for one use of the run's seed (``key`` names the use)."""
    return np.random.default_rng(
        np.random.SeedSequence(int(seed) & (2 ** 64 - 1), spawn_key=key))


TEXTS, ARRIVALS, SAMPLE, WEIGHTS = 1, 2, 3, 4


class TextStream:
    def __init__(self, spec: dict, corpus: Corpus, seed: int,
                 max_tokens: int):
        self.spec = spec
        self.corpus = corpus
        self.cap = max_tokens
        self.rng = rng(seed, TEXTS)
        self.i = 0
        self.seen = set()
        if spec["source"] == "sentences":
            n, w = len(corpus.sentences), len(corpus.affixes)
            self.order = self.rng.permutation(n)
            self.pairs = w * w
            self.p0 = int(self.rng.integers(self.pairs))
            stride = int(self.rng.integers(1, self.pairs))
            while math.gcd(stride, self.pairs) != 1:
                stride += 1
            self.stride = stride
        elif spec["source"] != "passages":
            raise ValueError(f"unknown text source {spec['source']!r}")

    def take(self, n: int) -> Tuple[List[str], np.ndarray]:
        """The next ``n`` texts and their token counts."""
        if self.spec["source"] == "sentences":
            return self._sentences(n)
        return self._passages(n)

    def _sentences(self, n: int):
        c = self.corpus
        idx = np.arange(self.i, self.i + n, dtype=np.int64)
        self.i += n
        nb, w = len(c.sentences), len(c.affixes)
        base = self.order[idx % nb]
        pair = (self.p0 + idx * self.stride) % self.pairs
        s, a = c.sentences, c.affixes
        texts = [f"{a[p // w]} {s[b]} {a[p % w]}"
                 for b, p in zip(base.tolist(), pair.tolist())]
        return texts, np.minimum(c.lengths[base] + 4, self.cap)

    def _passages(self, n: int):
        """``n`` passages whose token counts are the ``n``-point log-uniform
        grid between min_tokens and max_tokens, in an order drawn from the
        seed: every call of ``n`` has the same sizes, only the words
        differ. A passage is whole corpus sentences and the first words
        of one more, to its count exactly."""
        c = self.corpus
        lo, hi = math.log(self.spec["min_tokens"]), math.log(
            self.spec["max_tokens"])
        targets = np.rint(np.exp(lo + (hi - lo) * (np.arange(n) + 0.5) / n))
        self.rng.shuffle(targets)
        most = int(self.spec["max_tokens"] // max(1, c.lengths.min())) + 1
        texts: List[str] = []
        for target in targets.astype(np.int64).tolist():
            while True:
                picks = self.rng.integers(len(c.sentences), size=most)
                total = np.cumsum(c.lengths[picks]) + 2
                last = int(np.argmax(total >= target))
                cut = target - 2 - (int(total[last - 1]) - 2 if last else 0)
                head = [c.sentences[j] for j in picks[:last].tolist()]
                head.append(" ".join(c.words[picks[last]][:cut]))
                text = " ".join(head)
                if text not in self.seen:
                    break
            self.seen.add(text)
            texts.append(text)
        return texts, np.minimum(targets.astype(np.int64), self.cap)


def poisson_arrivals(rate_per_s: float, seconds: float,
                     generator: np.random.Generator) -> np.ndarray:
    """Arrival offsets in [0, seconds) of a Poisson process."""
    n = int(rate_per_s * seconds * 1.2) + 64
    t = np.cumsum(generator.exponential(1.0 / rate_per_s, size=n))
    while t[-1] < seconds:
        more = np.cumsum(generator.exponential(1.0 / rate_per_s, size=n))
        t = np.concatenate([t, t[-1] + more])
    return t[t < seconds]

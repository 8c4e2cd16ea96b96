"""The generator: deterministic per seed, the stated token counts, no
repeated text; Poisson arrivals."""

import numpy as np
import pytest

from gpubench import corpus, generate
from gpubench.registry import Registry

SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def corp():
    return corpus.load(Registry().config("bert_base_q4_0"))


@pytest.mark.parametrize("spec,n", [
    ({"source": "sentences"}, 3000),
    ({"source": "passages", "min_tokens": 64, "max_tokens": 512}, 300),
])
def test_deterministic_per_seed(corp, spec, n):
    a = generate.TextStream(spec, corp, SEED, 512).take(n)
    b = generate.TextStream(spec, corp, SEED, 512).take(n)
    c = generate.TextStream(spec, corp, SEED + 1, 512).take(n)
    assert a[0] == b[0] and np.array_equal(a[1], b[1])
    assert a[0] != c[0]


@pytest.mark.parametrize("spec,n,lo,hi", [
    ({"source": "sentences"}, 3000, 3 + 4, 30 + 4),
    ({"source": "passages", "min_tokens": 64, "max_tokens": 512}, 300, 64,
     512),
])
def test_stated_lengths(corp, spec, n, lo, hi):
    texts, counts = generate.TextStream(spec, corp, SEED, 512).take(n)
    tok = corp.tokenizer()
    assert [len(tok(t, 512)) for t in texts] == counts.tolist()
    assert counts.min() >= lo and counts.max() <= hi


def test_passage_lengths_are_log_uniform(corp):
    spec = {"source": "passages", "min_tokens": 64, "max_tokens": 512}
    _, counts = generate.TextStream(spec, corp, SEED, 512).take(2000)
    # a third of log(64..512) in each octave, less the cut at 512
    octave = np.histogram(np.log2(np.minimum(counts, 511)), bins=[6, 7, 8,
                                                                  9])[0]
    assert np.all(np.abs(octave / len(counts) - 1 / 3) < 0.06), octave


def test_no_repeated_text_within_a_run(corp):
    stream = generate.TextStream({"source": "sentences"}, corp, SEED, 512)
    texts = [t for _ in range(40) for t in stream.take(2758)[0]]
    assert len(set(texts)) == len(texts)
    spec = {"source": "passages", "min_tokens": 64, "max_tokens": 512}
    passages = generate.TextStream(spec, corp, SEED, 512).take(3000)[0]
    assert len(set(passages)) == len(passages)


def test_vocabulary(corp):
    v = corp.vocab
    assert len(v) == 30522
    assert (v[0], v[100], v[101], v[102], v[103]) == (
        "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
    assert len(set(v)) == len(v)
    assert len(corp.sentences) == 986


def test_poisson_arrivals():
    a = generate.poisson_arrivals(2000.0, 5.0, generate.rng(SEED, 2))
    b = generate.poisson_arrivals(2000.0, 5.0, generate.rng(SEED, 2))
    assert np.array_equal(a, b)
    assert a.min() >= 0 and a.max() < 5.0 and np.all(np.diff(a) > 0)
    assert abs(len(a) / 5.0 - 2000.0) < 4 * np.sqrt(2000 * 5) / 5

"""The benchmark's text material and vocabulary.

``data/sts_en.tsv`` (sentence pairs with a score) and
``data/emotion_en.tsv`` (a label and a sentence) hold 1,110 human-written
English sentences, 986 of them distinct. The vocabulary has the
configuration's ``vocab_size`` slots and bert-base-uncased's special ids
([PAD] 0, [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103); every word of the
corpus, as the tokenizer splits it, has a whole-word id from 999 on in
sorted order, and the other slots are ``[unusedN]``. So each corpus word
is one token and a text's token count is known from its parts.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import List

import numpy as np

from .reference.wordpiece import Tokenizer, words

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIRST_WORD_ID = 999
SPECIALS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
            103: "[MASK]"}


@dataclass(frozen=True)
class Corpus:
    sentences: List[str]     # distinct, in file order
    lengths: np.ndarray      # tokens of each, without [CLS]/[SEP]
    vocab: List[str]         # the configuration's vocab_size tokens
    affixes: List[str]       # alphabetic corpus words, one token each
    words: List[List[str]]   # each sentence's words, as the tokenizer splits

    def tokenizer(self) -> Tokenizer:
        return Tokenizer(self.vocab)


def _read_sentences() -> List[str]:
    out = []
    with open(os.path.join(DATA, "sts_en.tsv"), encoding="utf-8") as f:
        for line in f:
            a, b, _ = line.rstrip("\n").split("\t")
            out += [a, b]
    with open(os.path.join(DATA, "emotion_en.tsv"), encoding="utf-8") as f:
        for line in f:
            out.append(line.rstrip("\n").split("\t")[1])
    return list(dict.fromkeys(out))


def load(cfg: dict) -> Corpus:
    """The corpus with the vocabulary of the configuration ``cfg``."""
    return _load(int(cfg["vocab_size"]))


@functools.lru_cache(maxsize=4)
def _load(n_vocab: int) -> Corpus:
    sentences = _read_sentences()
    split = [words(s) for s in sentences]
    corpus_words = sorted({w for ws in split for w in ws})
    vocab = [SPECIALS.get(i, "") for i in range(FIRST_WORD_ID)]
    vocab += corpus_words
    unused = 0
    for i, tok in enumerate(vocab):
        if not tok:
            vocab[i] = f"[unused{unused}]"
            unused += 1
    while len(vocab) < n_vocab:
        vocab.append(f"[unused{unused}]")
        unused += 1
    affixes = [w for w in corpus_words if w.isalpha()]
    return Corpus(sentences=sentences,
                  lengths=np.array([len(ws) for ws in split], np.int64),
                  vocab=vocab, affixes=affixes, words=split)

"""WordPiece tokenizer with reference-exact semantics.

Re-implements the behavior of the reference tokenizer (bert.cpp:196-325)
as the host-side front-end of the engine (counterpart of
``bert_tpu/tokenizer.py``, with the same output):

  normalize (accent-strip + ASCII lowercase, bert.cpp:206-251)
  → word split on POSIX ``[[:punct:]]|[[:alpha:]]+|[[:digit:]]+`` (bert.cpp:270)
  → greedy longest-match WordPiece with whole-word/``##``-subword map
    switching (bert.cpp:289-322)
  → wrap in [CLS]/[SEP] (bert.cpp:259-260,286,323).

Deliberately preserved quirks (documented in SURVEY.md §7):
  * unknown characters are DROPPED (no [UNK] emitted), with a warning
    (bert.cpp:317-320);
  * after the first matched piece of a word the matcher switches to the
    subword map for the remainder (bert.cpp:310) — including after a
    skipped unknown char;
  * truncation: token emission stops at ``n_max_tokens - 1`` and [SEP] is
    always appended, so output length ≤ n_max_tokens (bert.cpp:300,323);
  * non-ASCII characters that survive accent stripping are dropped by the
    splitter (the reference's byte-oriented std::regex never matches
    bytes ≥ 0x80).

A native C++ implementation with identical semantics lives in
``csrc/wordpiece.cpp``; this module transparently uses it when the shared
library has been built (see bert_tpu_torch.native).
"""

from __future__ import annotations

import logging
import re
from typing import List, Optional, Sequence

import numpy as np

from .vocab import Vocab

logger = logging.getLogger(__name__)

# Exact accent-folding table of the reference (bert.cpp:209-219) — a Latin-1
# subset, NOT full Unicode NFD. Anything outside this table is left as-is and
# subsequently dropped by the ASCII-only word splitter.
ACCENT_MAP = {
    "À": "A", "Á": "A", "Â": "A", "Ã": "A", "Ä": "A", "Å": "A",
    "à": "a", "á": "a", "â": "a", "ã": "a", "ä": "a", "å": "a",
    "È": "E", "É": "E", "Ê": "E", "Ë": "E",
    "è": "e", "é": "e", "ê": "e", "ë": "e",
    "Ì": "I", "Í": "I", "Î": "I", "Ï": "I",
    "ì": "i", "í": "i", "î": "i", "ï": "i",
    "Ò": "O", "Ó": "O", "Ô": "O", "Õ": "O", "Ö": "O",
    "ò": "o", "ó": "o", "ô": "o", "õ": "o", "ö": "o",
    "Ù": "U", "Ú": "U", "Û": "U", "Ü": "U",
    "ù": "u", "ú": "u", "û": "u", "ü": "u",
    "Ý": "Y", "ý": "y",
    "Ç": "C", "ç": "c",
    "Ñ": "N", "ñ": "n",
}
_ACCENT_TRANS = str.maketrans(ACCENT_MAP)

# POSIX classes in the C locale, as std::regex resolves them on bytes
# (bert.cpp:270): punct = printable non-alnum ASCII; alpha/digit = ASCII.
_WORD_SPLIT_RE = re.compile(r"[!-/:-@\[-`{-~]|[a-zA-Z]+|[0-9]+")

_ASCII_UPPER = str.maketrans(
    {chr(c): chr(c + 32) for c in range(ord("A"), ord("Z") + 1)}
)


def normalize(text: str) -> str:
    """bert_normalize_prompt (bert.cpp:240-251): accent fold, then lowercase
    ASCII letters only (multi-byte chars are skipped by the reference loop)."""
    return text.translate(_ACCENT_TRANS).translate(_ASCII_UPPER)


def split_words(text: str) -> List[str]:
    """Word pre-split (bert.cpp:265-283). Characters that match none of the
    three POSIX classes (whitespace, non-ASCII) are discarded."""
    return _WORD_SPLIT_RE.findall(text)


class WordPieceTokenizer:
    """Greedy longest-match WordPiece over a :class:`Vocab`.

    Uses the native C++ core (csrc/wordpiece.cpp via bert_tpu_torch.native) when
    its shared library is available; the pure-Python path below is the
    reference implementation and permanent fallback. Both are pinned
    together by golden tests (tests/test_torch_engine.py).
    """

    def __init__(self, vocab: Vocab, warn_unknown: bool = True,
                 use_native: Optional[bool] = None):
        self.vocab = vocab
        self.warn_unknown = warn_unknown
        self._native = None
        if use_native is not False:
            try:
                from .native import NativeWordPiece

                if NativeWordPiece.available(auto_build=use_native is True):
                    self._native = NativeWordPiece(
                        vocab.tokens, vocab.cls_id, vocab.sep_id
                    )
            except (OSError, RuntimeError):
                if use_native is True:
                    raise

    def tokenize(self, text: str, n_max_tokens: Optional[int] = None) -> List[int]:
        """Text → token ids, [CLS] ... [SEP], truncated to ``n_max_tokens``.

        Mirrors bert_tokenize (bert.cpp:252-325). Token OUTPUT is
        bit-identical between the native and Python cores (fuzz-pinned for
        the shared native core in tests/test_native.py); the unknown-token
        WARNING side effect is Python-path only — the native core drops
        unknowns silently
        (warn_unknown has no effect when libwordpiece.so is active).
        """
        if self._native is not None:
            return self._native.tokenize(
                text, n_max_tokens if n_max_tokens is not None else 1 << 30
            )
        return self._tokenize_py(text, n_max_tokens)

    def _tokenize_py(self, text: str,
                     n_max_tokens: Optional[int] = None) -> List[int]:
        vocab = self.vocab
        cap = n_max_tokens if n_max_tokens is not None else 1 << 30
        if cap <= 0:
            return []
        if cap == 1:  # degenerate cap: [CLS] only (mirrors the native core)
            return [vocab.cls_id]

        tokens: List[int] = [vocab.cls_id]
        whole = vocab.token_to_id
        sub = vocab.subword_token_to_id

        for word in split_words(normalize(text)):
            if not word:
                continue
            i, n = 0, len(word)
            token_map = whole
            while i < n:
                if len(tokens) >= cap - 1:  # bert.cpp:300
                    break
                j = n
                matched = False
                while j > i:
                    tid = token_map.get(word[i:j])
                    if tid is not None:
                        tokens.append(tid)
                        i = j
                        token_map = sub  # bert.cpp:310
                        matched = True
                        break
                    j -= 1
                if not matched:
                    if self.warn_unknown:
                        logger.warning("unknown token %r", word[i])
                    token_map = sub  # bert.cpp:318
                    i += 1
        tokens.append(vocab.sep_id)  # bert.cpp:323
        return tokens

    def tokenize_batch(
        self, texts: Sequence[str], n_max_tokens: Optional[int] = None
    ) -> List[List[int]]:
        if self._native is not None and n_max_tokens is not None:
            # one FFI call for the whole batch (~4× faster than per-call)
            return self._native.tokenize_batch(texts, n_max_tokens)
        return [self.tokenize(t, n_max_tokens) for t in texts]

    def pad_batch(
        self,
        token_lists: Sequence[Sequence[int]],
        seq_len: int,
        batch_size: Optional[int] = None,
    ) -> tuple:
        """Dense [B, T] int32 ids + [B, T] float32 mask, padded with [PAD].

        Unlike the reference (which evaluates exact-length single sentences
        and never needed a mask, bert.cpp:845), the engine is batched and
        masked; padding goes to a small set of fixed bucket shapes.
        """
        b = batch_size if batch_size is not None else len(token_lists)
        pad = self.vocab.pad_id
        ids = np.full((b, seq_len), pad, dtype=np.int32)
        mask = np.zeros((b, seq_len), dtype=np.float32)
        for r, toks in enumerate(token_lists):
            t = list(toks)
            if len(t) > seq_len:
                # preserve the trailing token (the [SEP] of a well-formed
                # list) across truncation: the module contract is
                # truncate-then-[SEP], and chopping the tail would end the
                # sequence mid-word with no separator
                t = t[: seq_len - 1] + [t[-1]]
            ids[r, : len(t)] = t
            mask[r, : len(t)] = 1.0
        return ids, mask


def load_tokenizer(vocab_path: str) -> WordPieceTokenizer:
    """A tokenizer over an HF ``vocab.txt`` (one token per line)."""
    return WordPieceTokenizer(Vocab.from_vocab_txt(vocab_path))

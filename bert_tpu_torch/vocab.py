"""WordPiece vocabulary store.

Counterpart of ``bert_tpu/vocab.py`` (a copy: importing any ``bert_tpu``
module imports JAX). Re-design of the reference's vocab maps
(bert.cpp:57-64,121-134,378-403):
two lookup tables — whole-word ``token_to_id`` and ``##``-stripped
``subword_token_to_id`` — plus reverse maps for id→token introspection.

Semantics preserved from the reference loader (bert.cpp:383-402):
  * entries beginning with ``##`` populate the subword map with the prefix
    stripped, and keep the raw ``##xx`` string in the reverse map;
  * duplicate token strings: the FIRST id wins in ``token_to_id``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

# Hardcoded special token ids, as in the reference (bert.cpp:259-260).
# Correct for BERT-uncased-family vocabs; see Vocab.cls_id/sep_id for
# vocab-derived overrides.
DEFAULT_CLS_ID = 101
DEFAULT_SEP_ID = 102
DEFAULT_PAD_ID = 0


@dataclass
class Vocab:
    """Token-string ↔ id maps for WordPiece tokenization."""

    tokens: List[str]
    token_to_id: Dict[str, int] = field(default_factory=dict)
    subword_token_to_id: Dict[str, int] = field(default_factory=dict)
    _id_to_token: Dict[int, str] = field(default_factory=dict)
    _id_to_subword_token: Dict[int, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.token_to_id:
            for i, word in enumerate(self.tokens):
                if word.startswith("##"):
                    # subword map is keyed by the stripped suffix (bert.cpp:393)
                    self.subword_token_to_id.setdefault(word[2:], i)
                    self._id_to_subword_token[i] = word
                if word not in self.token_to_id:  # first-wins (bert.cpp:397)
                    self.token_to_id[word] = i
                    self._id_to_token[i] = word

    def __len__(self) -> int:
        return len(self.tokens)

    def id_to_token(self, token_id: int) -> Optional[str]:
        """Reverse lookup, preferring the raw ``##``-prefixed form for subword
        ids — mirrors bert_vocab_id_to_token (bert.cpp:121-134)."""
        if token_id in self._id_to_subword_token:
            return self._id_to_subword_token[token_id]
        return self._id_to_token.get(token_id)

    # -- special ids ---------------------------------------------------------
    def _special(self, name: str, default: int) -> int:
        return self.token_to_id.get(name, default)

    @property
    def cls_id(self) -> int:
        return self._special("[CLS]", DEFAULT_CLS_ID)

    @property
    def sep_id(self) -> int:
        return self._special("[SEP]", DEFAULT_SEP_ID)

    @property
    def pad_id(self) -> int:
        return self._special("[PAD]", DEFAULT_PAD_ID)

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_tokens(cls, tokens: List[str]) -> "Vocab":
        return cls(tokens=list(tokens))

    @classmethod
    def from_vocab_txt(cls, path: str) -> "Vocab":
        """Load a HuggingFace ``vocab.txt`` (one token per line, id = line no)."""
        with open(path, "r", encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        # trailing blank line is not a token
        while tokens and tokens[-1] == "":
            tokens.pop()
        return cls(tokens=tokens)

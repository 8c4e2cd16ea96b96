"""Plain reference of the reference tokenizer's semantics (bert.cpp's
``bert_tokenize``), written apart from the program under test:

  fold the Latin-1 accents of bert.cpp's table and lowercase ASCII letters;
  split into words: one ASCII punctuation mark, a run of ASCII letters or a
  run of ASCII digits (anything else is dropped);
  greedy longest match over the whole-word map, then over the ``##`` map
  for the rest of the word; a character that matches nothing is dropped
  and also switches to the ``##`` map;
  [CLS] first; emission stops once the list holds ``cap - 1`` ids; [SEP]
  last.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

_FOLD = {}
for _plain, _accented in (
        ("A", "ÀÁÂÃÄÅ"), ("a", "àáâãäå"), ("E", "ÈÉÊË"), ("e", "èéêë"),
        ("I", "ÌÍÎÏ"), ("i", "ìíîï"), ("O", "ÒÓÔÕÖ"), ("o", "òóôõö"),
        ("U", "ÙÚÛÜ"), ("u", "ùúûü"), ("Y", "Ý"), ("y", "ý"), ("C", "Ç"),
        ("c", "ç"), ("N", "Ñ"), ("n", "ñ")):
    for _c in _accented:
        _FOLD[_c] = _plain


def _kind(c: str) -> int:
    """0 = dropped, 1 = ASCII letter, 2 = ASCII digit, 3 = punctuation."""
    o = ord(c)
    if o > 126 or o < 33:
        return 0
    if c.isalpha():
        return 1
    if c.isdigit():
        return 2
    return 3


def words(text: str) -> List[str]:
    out: List[str] = []
    cur, cur_kind = [], 0
    for c in text:
        c = _FOLD.get(c, c)
        if "A" <= c <= "Z":
            c = chr(ord(c) + 32)
        k = _kind(c)
        if k != cur_kind or k == 3:
            if cur:
                out.append("".join(cur))
            cur, cur_kind = [], k
        if k:
            cur.append(c)
        else:
            cur_kind = 0
    if cur:
        out.append("".join(cur))
    return out


class Tokenizer:
    def __init__(self, tokens: Sequence[str], cls_id: int = 101,
                 sep_id: int = 102):
        self.whole: Dict[str, int] = {}
        self.sub: Dict[str, int] = {}
        for i, t in enumerate(tokens):
            if t.startswith("##"):
                self.sub.setdefault(t[2:], i)
            self.whole.setdefault(t, i)
        self.cls_id, self.sep_id = cls_id, sep_id

    def __call__(self, text: str, cap: int) -> List[int]:
        ids = [self.cls_id]
        for w in words(text):
            table, i = self.whole, 0
            while i < len(w) and len(ids) < cap - 1:
                for j in range(len(w), i, -1):
                    tid = table.get(w[i:j])
                    if tid is not None:
                        ids.append(tid)
                        i = j
                        break
                else:
                    i += 1
                table = self.sub
        ids.append(self.sep_id)
        return ids

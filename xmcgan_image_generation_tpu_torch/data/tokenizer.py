"""BERT (uncased) tokenizer: basic tokenization and WordPiece (a copy of
the JAX package's ``data/tokenizer.py``).

The reference shells out to ``bert-tensorflow``'s FullTokenizer
(reference preprocess_data.py:29-58).  This is a dependency-free
re-implementation of the same algorithm (lowercase, accent strip,
punctuation split, greedy longest-match-first WordPiece) driven by a
standard BERT ``vocab.txt``.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Tuple

CLS, SEP, UNK, PAD = "[CLS]", "[SEP]", "[UNK]", "[PAD]"


def load_vocab(path: str) -> Dict[str, int]:
  """``token -> line number`` of a ``vocab.txt`` (empty lines skipped, but
  counted)."""
  vocab: Dict[str, int] = {}
  with open(path, encoding="utf-8") as f:
    for i, line in enumerate(f):
      token = line.rstrip("\n")
      if token:
        vocab[token] = i
  return vocab


def _is_punctuation(ch: str) -> bool:
  """ASCII symbols count as punctuation, as in BERT, besides Unicode's P*
  categories."""
  cp = ord(ch)
  if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or
      123 <= cp <= 126):
    return True
  return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lower_case: bool = True) -> List[str]:
  """Whitespace and punctuation splitting, with lowercasing and the accent
  strip (NFD, combining marks dropped)."""
  if lower_case:
    text = text.lower()
    text = unicodedata.normalize("NFD", text)
    text = "".join(c for c in text if unicodedata.category(c) != "Mn")
  tokens: List[str] = []
  current: List[str] = []
  for ch in text:
    if ch.isspace():
      if current:
        tokens.append("".join(current))
        current = []
    elif _is_punctuation(ch):
      if current:
        tokens.append("".join(current))
        current = []
      tokens.append(ch)
    else:
      current.append(ch)
  if current:
    tokens.append("".join(current))
  return tokens


def wordpiece(token: str, vocab: Dict[str, int],
              max_chars: int = 200) -> List[str]:
  """Greedy longest-match-first subword split; ``[UNK]`` for a token longer
  than ``max_chars`` or one that no pieces cover."""
  if len(token) > max_chars:
    return [UNK]
  pieces: List[str] = []
  start = 0
  while start < len(token):
    end = len(token)
    piece = None
    while start < end:
      sub = token[start:end]
      if start > 0:
        sub = "##" + sub
      if sub in vocab:
        piece = sub
        break
      end -= 1
    if piece is None:
      return [UNK]
    pieces.append(piece)
    start = end
  return pieces


class BertTokenizer:
  """``text -> (ids, length)`` with [CLS]/[SEP] framing and padding.

  Matches the reference's caption preparation: tokenize, truncate to
  ``max_len - 2``, add CLS/SEP, pad with zeros, and report the true length
  including CLS/SEP (reference preprocess_data.py:36-58).
  """

  def __init__(self, vocab_path: str, lower_case: bool = True):
    self.vocab = load_vocab(vocab_path)
    self.lower_case = lower_case

  def tokenize(self, text: str) -> List[str]:
    out: List[str] = []
    for token in basic_tokenize(text, self.lower_case):
      out.extend(wordpiece(token, self.vocab))
    return out

  def encode(self, text: str, max_len: int = 17) -> Tuple[List[int], int]:
    tokens = self.tokenize(text)[:max_len - 2]
    tokens = [CLS] + tokens + [SEP]
    unknown = self.vocab.get(UNK, 0)
    ids = [self.vocab.get(t, unknown) for t in tokens]
    true_len = len(ids)
    ids = ids + [0] * (max_len - true_len)
    return ids, true_len

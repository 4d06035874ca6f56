"""The port's WordPiece tokenizer (`data/tokenizer.py`) against the JAX
package's, on a vocabulary made here: ids and true lengths exactly equal,
on chosen captions (accents, CJK and symbol punctuation, over-long words,
truncation, unknown pieces) and on random strings."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from xmcgan_image_generation_tpu.data import tokenizer as j_tok
from xmcgan_image_generation_tpu_torch.data import tokenizer as t_tok

VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "cat", "sits", "on", "the",
    "mat", "un", "##aff", "##able", "runn", "##ing", ".", ",", "!", "?",
    "cafe", "naive", "resume", "$", "^", "`", "~", "|", "(", ")", "-",
    "「", "」", "。", "猫", "日", "##本", "x", "##x", "dog", "##s", "red",
    "é", "##e",
]

TEXTS = [
    "A cat sits on the mat.",
    "Café, naïve, résumé!",
    "unaffable running dogs",
    "猫が日本にいる。「猫」",
    "a $cat^ on `the` ~mat| (red)-dog?",
    "zebra quokka axolotl",
    "x" * 201,
    "x" * 200,
    " ".join(["cat"] * 40),
    "",
    "   \t\n  ",
    "ÉCOLE Ünïcödé Ñandú",
    "a cat　sits on",
    "emoji 🐱 cat 🐶",
    "café é",
    "¿qué? ¡sí! «dog» — cat…",
]


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
  path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
  path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
  return str(path)


@pytest.fixture(scope="module")
def tokenizers(vocab_path):
  return j_tok.BertTokenizer(vocab_path), t_tok.BertTokenizer(vocab_path)


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
@pytest.mark.parametrize("max_len", [17, 5])
def test_encode_matches_jax(tokenizers, text, max_len):
  want, got = (t.encode(text, max_len) for t in tokenizers)
  assert got == want
  ids, true_len = got
  assert len(ids) == max_len and 2 <= true_len <= max_len
  assert ids[0] == VOCAB.index("[CLS]") and ids[true_len - 1] == 3


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_basic_tokenize_and_pieces_match_jax(tokenizers, text):
  j, t = tokenizers
  assert t_tok.basic_tokenize(text) == j_tok.basic_tokenize(text)
  assert t_tok.basic_tokenize(text, False) == j_tok.basic_tokenize(text,
                                                                   False)
  assert t.tokenize(text) == j.tokenize(text)


def test_cases_named_in_the_port():
  vocab = {t: i for i, t in enumerate(VOCAB)}
  assert t_tok.wordpiece("unaffable", vocab) == ["un", "##aff", "##able"]
  assert t_tok.wordpiece("x" * 201, vocab) == ["[UNK]"]
  assert t_tok.wordpiece("x" * 200, vocab) == ["x"] + ["##x"] * 199
  assert t_tok.wordpiece("zebra", vocab) == ["[UNK]"]
  assert t_tok.basic_tokenize("Café $5^") == ["cafe", "$", "5", "^"]


def test_unknown_without_unk_in_vocab(tmp_path):
  path = tmp_path / "vocab.txt"
  path.write_text("\n".join(["[CLS]", "[SEP]", "cat"]) + "\n")
  want = j_tok.BertTokenizer(str(path)).encode("cat zebra", 6)
  got = t_tok.BertTokenizer(str(path)).encode("cat zebra", 6)
  assert got == want == ([0, 2, 0, 1, 0, 0], 4)


def test_load_vocab_matches_jax(vocab_path):
  assert t_tok.load_vocab(vocab_path) == j_tok.load_vocab(vocab_path)


_ALPHABET = st.sampled_from(
    list("acdefgimnorstux .,!?$^`~|()-'\"") +
    ["é", "É", "ï", "ñ", "́", "猫", "日", "本", "。", "「", " ",
     "\t", "\n", "🐱", "ß", "İ", "Ⅻ", "​"])


@settings(max_examples=300, deadline=None)
@given(text=st.text(_ALPHABET, max_size=60) | st.text(max_size=40),
       max_len=st.integers(2, 24))
def test_random_strings_match_jax(tokenizers, text, max_len):
  j, t = tokenizers
  assert t.encode(text, max_len) == j.encode(text, max_len)

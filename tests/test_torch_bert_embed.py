"""The port's BERT encoder (`data/bert_embed.py`) against HuggingFace's
``FlaxBertModel``, the JAX package's encoder.

A small ``BertConfig`` (2 layers, hidden 64, 4 heads, FFN 128) is saved
by ``save_pretrained`` and read by the port's `build_bert` from the same
directory, without ``transformers``.  Its ``initializer_range`` is 0.5:
at HF's 0.02 the activations are so small that the exact (erf) and the
tanh GELU differ by ~3e-6, under the tolerance; at 0.5 the exact form
matches Flax to ~2e-5 and the tanh form misses by ~1e-3, so the float32
tolerance of 1e-4 tells them apart (`test_tanh_gelu_fails_the_tolerance`).
"""

import json

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import BertConfig, FlaxBertModel

from xmcgan_image_generation_tpu.data import bert_embed as j_bert
from xmcgan_image_generation_tpu.data import tokenizer as j_tok
from xmcgan_image_generation_tpu_torch.data import bert_embed
from xmcgan_image_generation_tpu_torch.data import tokenizer as t_tok

ATOL = 1e-4
L = 17
LENGTHS = [17, 4, 1, 0, 9, 2]
SMALL = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
             intermediate_size=128, initializer_range=0.5)
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "cat", "sits", "on",
         "the", "mat", "red", "dog", "##s", "runs", "."]
# `CaptionEmbedder` stores 768 features: one layer of that width, over
# this test's vocabulary.  At that width an initializer_range of 0.5 gives
# attention logits of ~200, whose near-ties two float32 summation orders
# resolve apart; 0.1 keeps them ~8.
WIDE = dict(vocab_size=len(VOCAB), num_hidden_layers=1, hidden_size=768,
            num_attention_heads=12, intermediate_size=256,
            initializer_range=0.1)


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
  path = tmp_path_factory.mktemp("bert_small")
  model = FlaxBertModel(BertConfig(**SMALL), seed=0)
  model.save_pretrained(str(path))
  return str(path), model


@pytest.fixture(scope="module")
def wide_dir(tmp_path_factory):
  path = tmp_path_factory.mktemp("bert_wide")
  FlaxBertModel(BertConfig(**WIDE), seed=1).save_pretrained(str(path))
  return str(path)


def _batch(seed=0, lengths=LENGTHS, vocab_size=30522):
  rng = np.random.default_rng(seed)
  ids = rng.integers(0, vocab_size, (len(lengths), L)).astype(np.int32)
  mask = (np.arange(L)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
  return ids, mask


def _flax(model, ids, mask):
  return np.asarray(model(input_ids=ids, attention_mask=mask)
                    .last_hidden_state)


def test_last_hidden_state_matches_flax(small_dir):
  path, model = small_dir
  ids, mask = _batch()
  want = _flax(model, ids, mask)
  got = bert_embed.build_bert(path, device="cpu")(ids, mask)
  assert got.dtype == torch.float32 and got.shape == (len(LENGTHS), L, 64)
  got = got.numpy()
  # The all-masked row attends uniformly and stays finite, as in Flax.
  assert np.isfinite(got).all()
  np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_tanh_gelu_fails_the_tolerance(small_dir):
  path, model = small_dir
  ids, mask = _batch()
  want = _flax(model, ids, mask)
  bert = bert_embed.load_pretrained(path)
  for layer in bert.layers:
    layer.act = torch.nn.GELU(approximate="tanh")
  with torch.no_grad():
    got = bert(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
  assert np.abs(got - want).max() > ATOL


@pytest.mark.parametrize("n,batch_size", [(11, 4), (3, 8), (8, 4)])
def test_caption_embedder_matches_jax(wide_dir, tmp_path, n, batch_size):
  path = wide_dir
  vocab = tmp_path / "vocab.txt"
  vocab.write_text("\n".join(VOCAB) + "\n")
  rng = np.random.default_rng(n)
  words = VOCAB[4:] + ["zebra", "Cat,", "dogs!"]
  captions = [" ".join(rng.choice(words, size=int(rng.integers(0, 20))))
              for _ in range(n)]
  j_embedder = j_bert.CaptionEmbedder(
      j_tok.BertTokenizer(str(vocab)), j_bert.build_bert(path), L,
      batch_size)
  calls = []
  t_embed = bert_embed.build_bert(path, device="cpu")

  def recorded(ids, mask):
    calls.append((ids.numpy().copy(), mask.numpy().copy()))
    return t_embed(ids, mask)

  t_embedder = bert_embed.CaptionEmbedder(
      t_tok.BertTokenizer(str(vocab)), recorded, L, batch_size)
  want_emb, want_len = j_embedder(captions)
  got_emb, got_len = t_embedder(captions)
  assert got_emb.shape == (n, L, bert_embed.BERT_DIM) == want_emb.shape
  np.testing.assert_array_equal(got_len, want_len)
  assert got_len.dtype == np.int64
  np.testing.assert_allclose(got_emb, want_emb, rtol=0, atol=ATOL)
  # Fixed-shape calls; the last chunk is padded with all-zero rows.
  assert len(calls) == -(-n // batch_size)
  for ids, mask in calls:
    assert ids.shape == mask.shape == (batch_size, L)
  pad = len(calls) * batch_size - n
  if pad:
    assert not calls[-1][0][-pad:].any() and not calls[-1][1][-pad:].any()
  assert set(t_embedder.seconds) == {"tokenize", "embed"}


def test_bert_base_through_load_flax_bert():
  config = BertConfig()
  model = FlaxBertModel(config, seed=0)
  params = jax.tree_util.tree_map(np.asarray, model.params)
  port = bert_embed.load_flax_bert(
      params, bert_embed.BertConfig.from_dict(config.to_dict()))
  assert port.config == bert_embed.BertConfig()
  ids, mask = _batch(1, lengths=[17, 6])
  want = _flax(model, ids, mask)
  with torch.no_grad():
    got = port(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_reads_a_tree_under_bert(small_dir, tmp_path):
  """Checkpoints of a model with heads (bert-base-uncased's) keep the
  encoder under ``bert``, beside the heads."""
  path, model = small_dir
  (tmp_path / "config.json").write_text(
      (open(f"{path}/config.json").read()))
  tree = {"bert": jax.tree_util.tree_map(np.asarray, model.params),
          "cls": {"predictions": {"bias": np.zeros(3, np.float32)}}}
  (tmp_path / "flax_model.msgpack").write_bytes(
      flax.serialization.to_bytes(tree))
  ids, mask = _batch(2)
  got = bert_embed.build_bert(str(tmp_path), device="cpu")(ids, mask)
  np.testing.assert_allclose(got.numpy(), _flax(model, ids, mask), rtol=0,
                             atol=ATOL)


@pytest.mark.parametrize("key,value", [("hidden_act", "gelu_new"),
                                       ("hidden_act", "relu"),
                                       ("position_embedding_type",
                                        "relative_key")])
def test_config_refuses_what_it_does_not_compute(key, value):
  with pytest.raises(ValueError, match=key):
    bert_embed.BertConfig.from_dict({**BertConfig().to_dict(), key: value})


def test_config_reads_the_fields(small_dir):
  path, _ = small_dir
  with open(f"{path}/config.json") as f:
    config = bert_embed.BertConfig.from_dict(json.load(f))
  assert config == bert_embed.BertConfig(
      hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
      intermediate_size=128, initializer_range=0.5)
  assert config.layer_norm_eps == 1e-12 and config.vocab_size == 30522


def test_missing_weights_are_named(small_dir, tmp_path):
  path, _ = small_dir
  (tmp_path / "config.json").write_text(open(f"{path}/config.json").read())
  with pytest.raises(FileNotFoundError, match="flax_model.msgpack"):
    bert_embed.build_bert(str(tmp_path), device="cpu")


def test_random_bert_base():
  """Without a path: BERT-base's geometry (HF's parameter count without
  the pooler), HF's initialization, the same weights from the same seed."""
  model = bert_embed.random_bert()
  n = sum(p.numel() for p in model.parameters())
  h = 768
  assert n == 109_482_240 - (h * h + h)
  for name, p in model.named_parameters():
    if "norm" in name:
      want = 1.0 if name.endswith("weight") else 0.0
      assert bool((p == want).all()), name
    elif name.endswith("bias"):
      assert not p.any(), name
    else:   # within 6 standard errors of normal(0, 0.02)
      assert abs(p.std().item() - 0.02) < 6 * 0.02 / (2 * p.numel())**0.5
      assert abs(p.mean().item()) < 6 * 0.02 / p.numel()**0.5, name
  again = bert_embed.random_bert()
  for a, b in zip(model.parameters(), again.parameters()):
    assert torch.equal(a, b)
  assert not torch.equal(model.layers[3].query.weight,
                         model.layers[4].query.weight)
  ids, mask = _batch(3, lengths=[17, 0])
  out = bert_embed.build_bert(None, device="cpu")(ids, mask)
  assert out.shape == (2, L, 768) and bool(torch.isfinite(out).all())


def test_refuses_cuda_without_a_card():
  if torch.cuda.is_available():
    pytest.skip("this machine has a card")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    bert_embed.build_bert(None, device="cuda")


def test_jax_gelu_default_is_the_tanh_form():
  """Why the port's GELU is not copied from ``jax.nn.gelu``'s default."""
  x = jnp.linspace(-3, 3, 7)
  exact = torch.nn.functional.gelu(torch.from_numpy(np.array(x)))
  assert not np.allclose(np.asarray(jax.nn.gelu(x)), exact.numpy(),
                         rtol=0, atol=1e-5)
  np.testing.assert_allclose(np.asarray(jax.nn.gelu(x, approximate=False)),
                             exact.numpy(), rtol=0, atol=1e-6)

"""The port's caption stage end to end against the JAX package's: COCO
preprocessing (`preprocess_coco.py`) into reference-schema shards, its PNG
encoder, and the `run_e2e` runbook.

JAX's ``tools/preprocess_coco.write_split`` and the port's write the same
fabricated PNG dataset with the same BERT directory (HuggingFace's
``FlaxBertModel`` on the JAX side, the port's reader of the same files on
the other): the shard names, the records' order, filenames, texts and
``max_len`` must be equal, the embeddings within 1e-4 and the pixels
decoded back equal (the PNG bytes may differ).  The JAX package's own
loader then reads the port's shards.  The runbook runs its preprocess and
train phases on the CPU; its eval phase (two 2048 x 2048 ``sqrtm``s) runs
on the card in ``chip_smoke.py``."""

import io
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image
from transformers import BertConfig, FlaxBertModel

from xmcgan_image_generation_tpu.data import bert_embed as j_bert
from xmcgan_image_generation_tpu.data import tokenizer as j_tok
from xmcgan_image_generation_tpu_torch import preprocess_coco
from xmcgan_image_generation_tpu_torch import run_e2e
from xmcgan_image_generation_tpu_torch.data import bert_embed
from xmcgan_image_generation_tpu_torch.data import png
from xmcgan_image_generation_tpu_torch.data import records
from xmcgan_image_generation_tpu_torch.data import tokenizer as t_tok

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools import preprocess_coco as j_pre  # noqa: E402

ATOL = 1e-4
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "cat", "sits", "on",
         "the", "mat", "red", "dog", "##s", "runs", "."]
# 768 features, as the records store; see tests/test_torch_bert_embed.py.
WIDE = dict(vocab_size=len(VOCAB), num_hidden_layers=1, hidden_size=768,
            num_attention_heads=12, intermediate_size=256,
            initializer_range=0.1)
BATCH = 10      # 2 images a BERT call
SIZES = [(40, 52), (48, 64), (31, 45), (24, 24), (50, 33), (36, 60),
         (29, 41)]
N_CAPTIONS = [5, 6, 3, 5, 7, 4, 5]   # 3 and 4 are repeated up to 5


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
  root = tmp_path_factory.mktemp("coco")
  bert_dir = root / "bert"
  FlaxBertModel(BertConfig(**WIDE), seed=2).save_pretrained(str(bert_dir))
  (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
  images_dir = root / "images"
  images_dir.mkdir()
  rng = np.random.default_rng(0)
  anns = {"images": [], "annotations": []}
  words = VOCAB[4:] + ["zebra", "Cat,", "dogs!"]
  for i, ((h, w), k) in enumerate(zip(SIZES, N_CAPTIONS)):
    name = f"img{i}.png"
    image = rng.integers(0, 256, (h, w, 3), np.uint8)
    if i % 3 == 2:   # a gray source
      Image.fromarray(image[:, :, 0]).save(images_dir / name)
    else:
      Image.fromarray(image).save(images_dir / name)
    # Image ids out of order: records go by id.
    image_id = (i * 5) % len(SIZES)
    anns["images"].append({"id": image_id, "file_name": name})
    for j in range(k):
      caption = " ".join(rng.choice(words, size=int(rng.integers(2, 25))))
      anns["annotations"].append({"image_id": image_id, "caption": caption})
  # A caption whose image the file does not list is dropped.
  anns["annotations"].append({"image_id": 99, "caption": "a cat"})
  ann_path = root / "captions.json"
  ann_path.write_text(json.dumps(anns))
  return root, str(images_dir), str(ann_path), str(bert_dir)


@pytest.fixture(scope="module")
def embedders(dataset):
  root, _, _, bert_dir = dataset
  vocab = str(root / "vocab.txt")
  j = j_bert.CaptionEmbedder(j_tok.BertTokenizer(vocab),
                             j_bert.build_bert(bert_dir), 17, BATCH)
  t = bert_embed.CaptionEmbedder(
      t_tok.BertTokenizer(vocab), bert_embed.build_bert(bert_dir, "cpu"),
      17, BATCH)
  return j, t


def _shards(directory):
  """The shard names (a reader caches its index beside as ``.idx``)."""
  return sorted(n for n in os.listdir(directory) if not n.endswith(".idx"))


def _records(path):
  f = records.TFRecordFile(str(path))
  return [records.parse_example(f.read(i)) for i in range(len(f))]


def _read(directory):
  return {name: _records(os.path.join(directory, name))
          for name in _shards(directory)}


def test_load_annotations_matches_jax(dataset):
  _, _, ann_path, _ = dataset
  got = preprocess_coco.load_annotations(ann_path)
  assert got == j_pre.load_annotations(ann_path)
  assert len(got) == len(SIZES)


@pytest.mark.parametrize("store_size", [0, 24])
@pytest.mark.parametrize("split", ["train", "val"])
def test_write_split_matches_jax(dataset, embedders, tmp_path, store_size,
                                 split):
  _, images_dir, ann_path, _ = dataset
  j_embedder, t_embedder = embedders
  examples = preprocess_coco.load_annotations(ann_path)
  j_pre.write_split(examples, j_embedder, images_dir, str(tmp_path / "j"),
                    split, num_shards=3, log_every=0, store_size=store_size)
  seconds = preprocess_coco.write_split(
      examples, t_embedder, images_dir, str(tmp_path / "t"), split,
      num_shards=3, log_every=0, store_size=store_size)
  assert seconds["images"] == len(examples)
  assert {"read_encode", "tokenize", "embed", "write"} <= set(seconds)
  want, got = _read(tmp_path / "j"), _read(tmp_path / "t")
  split_name = "validation" if split == "val" else split
  assert sorted(got) == sorted(want) == [
      f"coco2014_{split_name}.tfrecord-{i:05d}-of-00003" for i in range(3)]
  for shard in want:
    assert len(got[shard]) == len(want[shard]) > 0
    for g, w in zip(got[shard], want[shard]):
      assert set(g) == set(w)
      for key in ("image/filename", "caption/text", "caption/max_len"):
        np.testing.assert_array_equal(np.asarray(g[key]),
                                      np.asarray(w[key]))
      assert np.asarray(g["caption/max_len"]).dtype == np.int64
      g_emb, w_emb = (np.asarray(x["caption/embedding"], np.float32)
                      for x in (g, w))
      assert g_emb.shape == w_emb.shape == (5 * 17 * 768,)
      np.testing.assert_allclose(g_emb, w_emb, rtol=0, atol=ATOL)
      g_img, w_img = (png.decode(x["image"][0]) for x in (g, w))
      np.testing.assert_array_equal(g_img, w_img)
      if store_size:
        assert g_img.shape == (store_size, store_size, 3)


def test_jax_loader_reads_the_ports_shards(dataset, embedders, tmp_path):
  from xmcgan_image_generation_tpu.configs import coco_xmc
  from xmcgan_image_generation_tpu.data import pipeline

  _, images_dir, ann_path, _ = dataset
  _, t_embedder = embedders
  examples = preprocess_coco.load_annotations(ann_path)
  for split, shards in (("train", 2), ("val", 1)):
    preprocess_coco.write_split(examples, t_embedder, images_dir,
                                str(tmp_path), split, num_shards=shards,
                                log_every=0)
  config = coco_xmc.get_test_config()
  config.data_source = "tfrecord"
  config.data_dir = str(tmp_path) + "/"
  config.batch_size = 2
  config.d_step_per_g_step = 1
  config.eval_batch_size = 2
  train_loader, _, n = pipeline.create_datasets(config, seed=0)
  assert n == len(SIZES)
  batch = next(iter(train_loader))
  assert batch["image"].shape == (2, config.image_size, config.image_size, 3)
  assert batch["embedding"].shape == (2, 17, 768)
  assert batch["max_len"].min() >= 2


@pytest.mark.parametrize("count", [1, 2])
def test_fewer_than_three_captions_raise(dataset, embedders, tmp_path, count):
  _, images_dir, _, _ = dataset
  _, t_embedder = embedders
  examples = [("img0.png", ["a cat"] * 5), ("img1.png", ["a dog"] * count)]
  with pytest.raises(ValueError, match="img1.png"):
    preprocess_coco.write_split(examples, t_embedder, images_dir,
                                str(tmp_path), "train", num_shards=1,
                                log_every=0)


@pytest.mark.parametrize("store_size", [0, 20])
def test_jpeg_source_through_pillow(tmp_path, store_size):
  """A JPEG (COCO's own format) goes through Pillow, as in the JAX
  package; the pixels equal those of JAX's ``encode_image_png``."""
  path = tmp_path / "x.jpg"
  image = np.random.default_rng(3).integers(0, 256, (30, 44, 3), np.uint8)
  Image.fromarray(image).save(path, quality=90)
  got = png.decode(preprocess_coco.encode_image_png(str(path), store_size))
  want = png.decode(j_pre.encode_image_png(str(path), store_size))
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(37, 53, 3), (37, 53, 4), (37, 53),
                                   (1, 1, 3), (480, 640, 3)])
def test_png_encode_round_trip(shape):
  rng = np.random.default_rng(len(shape))
  image = rng.integers(0, 256, shape, np.uint8)
  if shape[0] > 100:   # smooth content, where the filters matter
    image = np.cumsum(rng.integers(-2, 3, shape), axis=1).astype(np.uint8)
  data = png.encode(image)
  pil = np.asarray(Image.open(io.BytesIO(data)))
  np.testing.assert_array_equal(pil, image)
  rgb = png.decode(data)
  want = image if image.ndim == 2 else image[:, :, :3]
  if image.ndim == 2:
    want = np.repeat(image[:, :, None], 3, axis=2)
  np.testing.assert_array_equal(rgb, want)


def test_png_encode_named_filters():
  image = np.random.default_rng(5).integers(0, 256, (12, 9, 3), np.uint8)
  data = png.encode(image, filters=range(5))
  raw, height, width, bpp = png._layout(data, "test")
  kinds = np.frombuffer(raw, np.uint8).reshape(height, width * bpp + 1)[:, 0]
  assert kinds.tolist() == [0, 1, 2, 3, 4] * 2 + [0, 1]
  np.testing.assert_array_equal(png.decode(data, plain=True), image)
  np.testing.assert_array_equal(
      np.asarray(Image.open(io.BytesIO(data))), image)


def test_run_e2e_smoke_on_cpu(tmp_path):
  """The runbook's smoke: fabricated PNGs, a random BERT-base, records, 2
  training steps (its eval phase runs on the card in chip_smoke.py)."""
  workdir = tmp_path / "exp"
  run_e2e.main(["--smoke", f"--workdir={workdir}", "--device=cpu",
                "--phase=preprocess,train"])
  shards = _shards(workdir / "records")
  assert shards == [f"coco2014_{s}.tfrecord-{i:05d}-of-00002"
                    for s in ("train", "validation") for i in range(2)]
  texts = [r["caption/text"] for s in shards if "train" in s
           for r in _records(workdir / "records" / s)]
  assert len(texts) == 8 and all(len(t) == 5 for t in texts)
  lines = [json.loads(x) for x in
           (workdir / "metrics.jsonl").read_text().splitlines()]
  assert max(x["step"] for x in lines) == 2
  assert (workdir / "checkpoints" / "TRAIN_DONE").exists()
  # The same fabricated images as the JAX runbook's (which writes them
  # with Pillow): the same seeded draws.
  first = png.decode((workdir / "train_images" / "train_0000.png")
                     .read_bytes())
  rng = np.random.default_rng(0)
  np.testing.assert_array_equal(first,
                                rng.integers(0, 256, (48, 64, 3), np.uint8))

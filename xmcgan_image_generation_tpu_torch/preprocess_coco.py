"""Offline COCO preprocessing: images and captions -> training TFRecords
(the JAX package's ``tools/preprocess_coco.py``).

BERT caption embedding runs as a batched job on the card
(`data.bert_embed`), and records are written with the port's TF-free
codec (`data.records`) in the reference schema: a PNG ``image``,
``image/filename``, ``caption/embedding`` (float32 ``[5, 17, 768]``,
raveled), ``caption/max_len`` (int64 ``[5]``) and ``caption/text``; shards
``coco{version}_{split}.tfrecord-{i:05d}-of-{n:05d}`` (``val`` is written
as ``validation``), which ``--data_source=tfrecord`` of the port's (and
the JAX package's) training reads.

Input: a COCO-2014 captions annotation file and its image directory (the
standard ``captions_train2014.json`` layout).  PNG sources are read by the
port's own decoder; any other format (COCO's own images are JPEG) needs
Pillow, imported only for such a file.  Usage::

  python -m xmcgan_image_generation_tpu_torch.preprocess_coco \\
      --annotations=annotations/captions_train2014.json \\
      --images_dir=train2014/ --output_dir=data/ --split=train \\
      --vocab=/path/to/vocab.txt [--bert_path=/path/to/hf-bert-base-uncased]
      [--store_size=256] [--device=cuda|cpu]

``--bert_path`` is a HuggingFace directory with ``config.json`` and
``flax_model.msgpack``; without it a random BERT-base stands in.  It runs
on the card unless ``--device=cpu`` is given, and fails without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from xmcgan_image_generation_tpu_torch.data import png
from xmcgan_image_generation_tpu_torch.data import records
from xmcgan_image_generation_tpu_torch.data import resize
from xmcgan_image_generation_tpu_torch.data.bert_embed import (
    BERT_DIM,
    CaptionEmbedder,
    build_bert,
)
from xmcgan_image_generation_tpu_torch.data.tokenizer import BertTokenizer

SENTENCE_NUM = 5
MAX_TEXT_LENGTH = 17
MIN_CAPTIONS = 3   # (c + c[:5])[:5] has 5 captions from 3 on


def load_annotations(path: str) -> List[Tuple[str, List[str]]]:
  """``[(filename, [captions...])]`` from a COCO captions json, by image
  id; captions of an image the file does not list are dropped."""
  with open(path) as f:
    data = json.load(f)
  files = {img["id"]: img["file_name"] for img in data["images"]}
  captions = collections.defaultdict(list)
  for ann in data["annotations"]:
    captions[ann["image_id"]].append(ann["caption"])
  return [(files[i], caps) for i, caps in sorted(captions.items())
          if i in files]


def _read_with_pillow(path: str) -> np.ndarray:
  try:
    from PIL import Image
  except ImportError as e:
    raise RuntimeError(
        f"{path}: not a PNG; Pillow is needed for non-PNG sources (PNG "
        f"sources are read without it)") from e
  with Image.open(path) as img:
    return np.asarray(img.convert("RGB"))


def encode_image_png(path: str, store_size: int = 0) -> bytes:
  """Reads an image and re-encodes it as PNG, optionally pre-resized.

  ``store_size`` hoists the training-time resize offline: the loader
  bilinearly resizes every image to ``config.image_size`` square before
  any random augmentation (`data.preprocessing`), so storing
  ``resize(img, (S, S))`` with Pillow's bilinear kernel (`data.resize`,
  bit for bit) yields the same training examples from PNGs ~10x smaller
  and ~10x faster to decode.  0 keeps the reference's full-resolution
  layout (reference preprocess_data.py:80).
  """
  with open(path, "rb") as f:
    data = f.read()
  if data[:len(png.SIGNATURE)] == png.SIGNATURE:
    image = png.decode(data, name=path)
  else:
    image = _read_with_pillow(path)
  if store_size and image.shape[:2] != (store_size, store_size):
    image = resize.resize_uint8(image, store_size, store_size)
  return png.encode(image)


def _five_captions(filename: str, caps: Sequence[str]) -> List[str]:
  chosen = (list(caps) + list(caps[:SENTENCE_NUM]))[:SENTENCE_NUM]
  if len(chosen) < SENTENCE_NUM:
    raise ValueError(f"image {filename}: {len(caps)} captions; at least "
                     f"{MIN_CAPTIONS} are needed to store {SENTENCE_NUM}")
  return chosen


def write_split(examples, embedder: CaptionEmbedder, images_dir: str,
                output_dir: str, split: str, coco_version: str = "2014",
                num_shards: int = 100, log_every: int = 500,
                store_size: int = 0) -> Dict[str, float]:
  """Writes ``examples`` (`load_annotations`) as ``num_shards`` shards,
  round robin, embedding a block of ``batch_size // 5`` images' captions
  a call.  Returns the host seconds by stage (``read_encode``,
  ``tokenize``, ``embed``, ``write``) and the count of ``images``."""
  os.makedirs(output_dir, exist_ok=True)
  split_name = "validation" if split == "val" else split
  writers = [
      records.TFRecordWriter(os.path.join(
          output_dir,
          f"coco{coco_version}_{split_name}.tfrecord-{i:05d}-of-"
          f"{num_shards:05d}"))
      for i in range(num_shards)
  ]
  seconds = {"read_encode": 0.0, "tokenize": 0.0, "embed": 0.0,
             "write": 0.0}
  before = dict(embedder.seconds)
  # 5 captions an image, so a block of batch // 5 images fills a batch.
  block = max(1, embedder.batch_size // SENTENCE_NUM)
  n = 0
  try:
    for start in range(0, len(examples), block):
      chunk = examples[start:start + block]
      padded = [(f, _five_captions(f, c)) for f, c in chunk]
      flat_caps = [c for _, caps in padded for c in caps]
      embedding, max_len = embedder(flat_caps)
      embedding = embedding.reshape(len(padded), SENTENCE_NUM,
                                    MAX_TEXT_LENGTH, BERT_DIM)
      max_len = max_len.reshape(len(padded), SENTENCE_NUM)
      for i, (filename, caps) in enumerate(padded):
        t0 = time.perf_counter()
        image_png = encode_image_png(
            os.path.join(images_dir, filename), store_size=store_size)
        t1 = time.perf_counter()
        example = records.build_example({
            "image": image_png,
            "image/filename": [filename.encode()],
            "caption/embedding": embedding[i].astype(np.float32).ravel(),
            "caption/max_len": np.asarray(max_len[i], np.int64),
            "caption/text": [c.encode() for c in caps],
        })
        writers[n % num_shards].write(example)
        seconds["read_encode"] += t1 - t0
        seconds["write"] += time.perf_counter() - t1
        if log_every and n % log_every == 0:
          print(f"{split}: {n}/{len(examples)}", flush=True)
        n += 1
  finally:
    for w in writers:
      w.close()
  for key in ("tokenize", "embed"):
    seconds[key] = embedder.seconds[key] - before[key]
  seconds["images"] = n
  return seconds


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--annotations", required=True)
  parser.add_argument("--images_dir", required=True)
  parser.add_argument("--output_dir", required=True)
  parser.add_argument("--split", choices=("train", "val"), required=True)
  parser.add_argument("--bert_path", default="",
                      help="Local HF bert-base-uncased dir (random init "
                           "if empty)")
  parser.add_argument("--vocab", required=True, help="BERT vocab.txt path")
  parser.add_argument("--num_shards", type=int, default=100)
  parser.add_argument("--batch_size", type=int, default=256)
  parser.add_argument("--limit", type=int, default=0)
  parser.add_argument("--store_size", type=int, default=0,
                      help="Pre-resize stored images to this square size "
                           "(0 = full resolution, reference parity). See "
                           "encode_image_png.")
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)

  tokenizer = BertTokenizer(args.vocab)
  embed_fn = build_bert(args.bert_path or None, args.device)
  embedder = CaptionEmbedder(
      tokenizer, embed_fn, MAX_TEXT_LENGTH, args.batch_size)
  examples = load_annotations(args.annotations)
  if args.limit:
    examples = examples[:args.limit]
  print(f"{len(examples)} images in {args.split}")
  seconds = write_split(examples, embedder, args.images_dir, args.output_dir,
                        args.split, num_shards=args.num_shards,
                        store_size=args.store_size)
  print(f"host seconds by stage: {json.dumps(seconds)}")


if __name__ == "__main__":
  main()

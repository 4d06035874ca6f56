"""Real-data runbook: raw COCO -> TFRecords -> train -> eval (the JAX
package's ``tools/run_e2e.py``).

One documented path from (BERT weights, COCO-2014 images and annotations,
InceptionV3 weights, pretrained ResNet ``.npy``) to a scored training run::

  python -m xmcgan_image_generation_tpu_torch.run_e2e \\
      --images_train=train2014/ --annotations_train=captions_train2014.json \\
      --images_val=val2014/    --annotations_val=captions_val2014.json \\
      --bert_path=/weights/bert-base-uncased --vocab=/weights/vocab.txt \\
      --inception_ckpt=/weights/inception_v3.npz \\
      --resnet_npy=/weights/resnet_pretrained.npy \\
      --data_dir=data/ --workdir=/tmp/exp [--device=cuda|cpu]

Phases (``--phase=preprocess,train,eval`` selects a subset; production
runs train and eval as two concurrent jobs, the reference's
train.sh/test.sh split):

  1. preprocess: BERT-embed captions, write reference-schema TFRecords
     (`preprocess_coco`).
  2. train:      the training loop on the records (`train.train`).
  3. eval:       the checkpoint-polling FID/IS service -> scores.csv
     (`evaluate.evaluate_continuously`).

``--smoke`` fabricates a tiny COCO-shaped dataset (random PNG images, a
toy vocabulary, random-init BERT and towers) and runs every phase end to
end on ``--device``, the card unless ``--device=cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from xmcgan_image_generation_tpu_torch.data import png


def fabricate_smoke_dataset(root: str):
  """Writes a tiny COCO-layout dataset (PNG images, annotation jsons, a
  vocabulary); returns ``({split: (images_dir, annotations)}, vocab)``."""
  rng = np.random.default_rng(0)
  vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "red", "blue", "cat",
           "dog", "on", "the", "mat", "grass", "sits", "runs", "."]
  vocab_path = os.path.join(root, "vocab.txt")
  with open(vocab_path, "w") as f:
    f.write("\n".join(vocab) + "\n")

  words = vocab[4:]
  splits = {}
  for split, n_images in (("train", 8), ("val", 6)):
    images_dir = os.path.join(root, f"{split}_images")
    os.makedirs(images_dir, exist_ok=True)
    images, annotations = [], []
    for i in range(n_images):
      name = f"{split}_{i:04d}.png"
      arr = rng.integers(0, 256, (48, 64, 3), np.uint8)
      with open(os.path.join(images_dir, name), "wb") as f:
        f.write(png.encode(arr))
      images.append({"id": i, "file_name": name})
      for j in range(5):
        caption = " ".join(rng.choice(words, size=int(rng.integers(3, 8))))
        annotations.append({"image_id": i, "caption": caption,
                            "id": i * 5 + j})
    ann_path = os.path.join(root, f"captions_{split}.json")
    with open(ann_path, "w") as f:
      json.dump({"images": images, "annotations": annotations}, f)
    splits[split] = (images_dir, ann_path)
  return splits, vocab_path


def build_config(args):
  from xmcgan_image_generation_tpu_torch.configs import coco_xmc

  if args.smoke:
    config = coco_xmc.get_test_config()
    config.update(num_train_steps=2, batch_size=8, eval_batch_size=8,
                  eval_num=8, checkpoint_every_steps=2, grain_worker_count=0)
  else:
    config = coco_xmc.get_config()
  config.update(data_source="tfrecord", data_dir=args.data_dir,
                resnet_ckpt_path=args.resnet_npy,
                inception_ckpt_path=args.inception_ckpt)
  return config


def run_preprocess(args):
  """Returns each split's host seconds by stage (`write_split`)."""
  from xmcgan_image_generation_tpu_torch import preprocess_coco
  from xmcgan_image_generation_tpu_torch.data.bert_embed import (
      CaptionEmbedder,
      build_bert,
  )
  from xmcgan_image_generation_tpu_torch.data.tokenizer import BertTokenizer

  tokenizer = BertTokenizer(args.vocab)
  embed_fn = build_bert(args.bert_path or None, args.device)
  embedder = CaptionEmbedder(tokenizer, embed_fn,
                             batch_size=args.bert_batch_size)
  seconds = {}
  for split, images_dir, annotations in (
      ("train", args.images_train, args.annotations_train),
      ("val", args.images_val, args.annotations_val)):
    examples = preprocess_coco.load_annotations(annotations)
    if args.limit:
      examples = examples[:args.limit]
    print(f"preprocess {split}: {len(examples)} images")
    seconds[split] = preprocess_coco.write_split(
        examples, embedder, images_dir, args.data_dir, split,
        num_shards=args.num_shards)
  return seconds


def run_train(args, config):
  from xmcgan_image_generation_tpu_torch import train as train_lib

  train_lib.train(config, args.workdir, args.device)


def run_eval(args, config):
  from xmcgan_image_generation_tpu_torch import evaluate as eval_lib

  eval_lib.evaluate_continuously(config, args.workdir, args.device,
                                 timeout=args.eval_timeout)
  scores = os.path.join(args.workdir, "checkpoints", "scores.csv")
  if os.path.exists(scores):
    with open(scores) as f:
      print(f.read())


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--smoke", action="store_true",
                      help="fabricate a tiny dataset and run all phases")
  parser.add_argument("--phase", default="preprocess,train,eval")
  parser.add_argument("--images_train", default="")
  parser.add_argument("--annotations_train", default="")
  parser.add_argument("--images_val", default="")
  parser.add_argument("--annotations_val", default="")
  parser.add_argument("--bert_path", default="")
  parser.add_argument("--vocab", default="")
  parser.add_argument("--inception_ckpt", default="")
  parser.add_argument("--resnet_npy", default="")
  parser.add_argument("--data_dir", default="data/")
  parser.add_argument("--workdir", required=True)
  parser.add_argument("--num_shards", type=int, default=100)
  parser.add_argument("--bert_batch_size", type=int, default=256)
  parser.add_argument("--limit", type=int, default=0)
  parser.add_argument("--eval_timeout", type=int, default=24 * 3600)
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)
  logging.basicConfig(level=logging.INFO)

  if args.smoke:
    os.makedirs(args.workdir, exist_ok=True)
    args.data_dir = os.path.join(args.workdir, "records")
    splits, vocab_path = fabricate_smoke_dataset(args.workdir)
    args.images_train, args.annotations_train = splits["train"]
    args.images_val, args.annotations_val = splits["val"]
    args.vocab = vocab_path
    args.num_shards = 2
    args.bert_batch_size = 16
    args.eval_timeout = 600

  phases = args.phase.split(",")
  config = build_config(args)
  if "preprocess" in phases:
    print(f"preprocess host seconds: {json.dumps(run_preprocess(args))}")
  if "train" in phases:
    run_train(args, config)
  if "eval" in phases:
    run_eval(args, config)
  print("e2e runbook done")


if __name__ == "__main__":
  main()

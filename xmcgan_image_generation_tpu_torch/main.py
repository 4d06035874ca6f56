"""Command line: ``python -m xmcgan_image_generation_tpu_torch.main
--workdir=DIR [--config=default|test] [--mode=train|test|generate]
[--device=cuda] [--data_source=tfrecord|synthetic] [--data_dir=DIR]
[--coco_version=2014] [--num_train_steps=N] [--config.KEY=VALUE ...]``.

``--mode=train`` trains (resuming from the workdir's checkpoints),
``--mode=test`` runs the checkpoint-polling FID/IS service against the
same workdir and ``--mode=generate`` writes sample grids from its latest
checkpoint.  Each runs on the CUDA card unless ``--device=cpu`` is given,
and fails when there is no card.  The configuration is
`configs.coco_xmc.get_config`; the data flags override its
``data_source`` (``tfrecord`` by default: the COCO shards that the JAX
package's ``tools/preprocess_coco.py`` writes, ``*{coco_version}*train
.tfrecord*`` and ``*{coco_version}*validation.tfrecord*`` under
``data_dir``), ``data_dir`` and ``coco_version``.  ``--config.KEY=VALUE``
sets any other key of the configuration, as the JAX package's command
line does; the value is read as a Python literal
(``--config.lr_schedule=cosine``, ``--config.grain_worker_count=4``).
"""

from __future__ import annotations

import argparse
import ast
import logging

from xmcgan_image_generation_tpu_torch.configs import coco_xmc


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--workdir", required=True)
  parser.add_argument("--config", default="default",
                      choices=("default", "test"))
  parser.add_argument("--mode", default="train",
                      choices=("train", "test", "generate"))
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--num_train_steps", type=int, default=None)
  parser.add_argument("--data_source", default=None,
                      choices=("tfrecord", "synthetic"))
  parser.add_argument("--data_dir", default=None)
  parser.add_argument("--coco_version", default=None)
  args, overrides = parser.parse_known_args(argv)
  logging.basicConfig(level=logging.INFO)
  config = coco_xmc.get_config(args.config)
  for key in ("num_train_steps", "data_source", "data_dir", "coco_version"):
    if getattr(args, key) is not None:
      config[key] = getattr(args, key)
  for item in overrides:
    key, sep, value = item.partition("=")
    if not (key.startswith("--config.") and sep):
      parser.error(f"unrecognized argument {item!r}")
    key = key[len("--config."):]
    if key not in config:
      parser.error(f"the configuration has no key {key!r}")
    try:
      config[key] = ast.literal_eval(value)
    except (ValueError, SyntaxError):
      config[key] = value
  if args.mode == "train":
    from xmcgan_image_generation_tpu_torch import train as train_lib
    train_lib.train(config, args.workdir, args.device)
  elif args.mode == "test":
    from xmcgan_image_generation_tpu_torch import evaluate as eval_lib
    eval_lib.evaluate_continuously(config, args.workdir, args.device)
  else:
    from xmcgan_image_generation_tpu_torch import generate as gen_lib
    gen_lib.generate(config, args.workdir, args.device)


if __name__ == "__main__":
  main()

"""Command line: ``python -m xmcgan_image_generation_tpu_torch.main
--workdir=DIR [--config=default|test] [--mode=train|test|generate]
[--device=cuda]``.

``--mode=train`` trains (resuming from the workdir's checkpoints),
``--mode=test`` runs the checkpoint-polling FID/IS service against the
same workdir and ``--mode=generate`` writes sample grids from its latest
checkpoint.  Each runs on the CUDA card unless ``--device=cpu`` is given,
and fails when there is no card.  The configuration is
`configs.coco_xmc.get_config` with ``data_source="synthetic"``.
"""

from __future__ import annotations

import argparse
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
  args = parser.parse_args(argv)
  logging.basicConfig(level=logging.INFO)
  config = coco_xmc.get_config(args.config)
  config.data_source = "synthetic"
  if args.num_train_steps is not None:
    config.num_train_steps = args.num_train_steps
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

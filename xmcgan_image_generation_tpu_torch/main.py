"""Command line: ``python -m xmcgan_image_generation_tpu_torch.main
--workdir=DIR [--config=default|test] [--mode=train] [--device=cuda]``.

Only ``--mode=train`` is ported.  It trains on the CUDA card unless
``--device=cpu`` is given, and fails when there is no card.  The configuration is
`configs.coco_xmc.get_config` with ``data_source="synthetic"``.
"""

from __future__ import annotations

import argparse
import logging

from xmcgan_image_generation_tpu_torch import train as train_lib
from xmcgan_image_generation_tpu_torch.configs import coco_xmc


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--workdir", required=True)
  parser.add_argument("--config", default="default",
                      choices=("default", "test"))
  parser.add_argument("--mode", default="train", choices=("train",))
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--num_train_steps", type=int, default=None)
  args = parser.parse_args(argv)
  logging.basicConfig(level=logging.INFO)
  config = coco_xmc.get_config(args.config)
  config.data_source = "synthetic"
  if args.num_train_steps is not None:
    config.num_train_steps = args.num_train_steps
  train_lib.train(config, args.workdir, args.device)


if __name__ == "__main__":
  main()

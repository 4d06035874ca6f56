"""Command line: ``python -m xmcgan_image_generation_tpu_torch.main
--workdir=DIR [--config=default|test|FILE[:VARIANT]]
[--mode=train|test|generate|export]
[--device=cuda] [--data_source=tfrecord|synthetic] [--data_dir=DIR]
[--coco_version=2014] [--num_train_steps=N] [--config.KEY=VALUE ...]``.

``--mode=train`` trains (resuming from the workdir's checkpoints),
``--mode=test`` runs the checkpoint-polling FID/IS service against the
same workdir, ``--mode=generate`` writes sample grids from its latest
checkpoint and ``--mode=export`` writes a serving artifact of its EMA
weights (`utils.serving.export_from_workdir`:
``{workdir}/serving/generator_ema_step{N:08d}.pt2`` and ``.json``).  Each
runs on the CUDA card unless ``--device=cpu`` is given, and fails when
there is no card.  The configuration is
`configs.coco_xmc.get_config` (``default``, ``test``) or, as with the JAX
package's config files, ``get_config(VARIANT)`` of a port config file
(``--config=xmcgan_image_generation_tpu_torch/configs/coco_xmc_256.py``,
``...coco_xmc_256.py:test``); the data flags override its
``data_source`` (``tfrecord`` by default: the COCO shards that the JAX
package's ``tools/preprocess_coco.py`` writes, ``*{coco_version}*train
.tfrecord*`` and ``*{coco_version}*validation.tfrecord*`` under
``data_dir``), ``data_dir`` and ``coco_version``.  ``--config.KEY=VALUE``
sets any other key of the configuration, as the JAX package's command
line does; the value is read as a Python literal
(``--config.lr_schedule=cosine``, ``--config.grain_worker_count=4``).

``torchrun --nproc_per_node=N -m xmcgan_image_generation_tpu_torch.main
--mode=...`` runs any mode over N processes, one device each
(``--device=cuda`` is ``cuda:LOCAL_RANK``, NCCL; with ``--device=cpu``,
gloo), as the JAX package runs each on an N-device ``data`` mesh:
``train`` trains one model (`train`); ``test`` is one evaluation service
whose processes score their rows of every eval batch and merge the
statistics once, process 0 choosing the checkpoints and writing
``scores.csv`` (`evaluate`); ``generate`` generates each process's rows
and process 0 writes the grids (`generate`); ``export`` writes the
artifacts once, from process 0 (`utils.serving.export_from_workdir`).
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import logging
import os

from xmcgan_image_generation_tpu_torch.configs import coco_xmc


def load_config(spec: str):
  """``default`` or ``test`` (`configs.coco_xmc`), or ``FILE[:VARIANT]``:
  ``get_config(VARIANT)`` (``get_config()`` without one) of the config
  file at ``FILE``."""
  if spec in ("default", "test"):
    return coco_xmc.get_config(spec)
  path, _, variant = spec.partition(":")
  if not os.path.isfile(path):
    raise ValueError(f"--config={spec!r}: no config file {path!r}")
  module_spec = importlib.util.spec_from_file_location(
      "_xmcgan_config", path)
  module = importlib.util.module_from_spec(module_spec)
  module_spec.loader.exec_module(module)
  return module.get_config(variant) if variant else module.get_config()


def config_from_args(parser: argparse.ArgumentParser, spec: str,
                     overrides):
  """`load_config` of ``spec`` with each ``--config.KEY=VALUE`` of
  ``overrides`` applied; errors through ``parser``."""
  try:
    config = load_config(spec)
  except ValueError as e:
    parser.error(str(e))
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
  return config


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--workdir", required=True)
  parser.add_argument("--config", default="default")
  parser.add_argument("--mode", default="train",
                      choices=("train", "test", "generate", "export"))
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--num_train_steps", type=int, default=None)
  parser.add_argument("--data_source", default=None,
                      choices=("tfrecord", "synthetic"))
  parser.add_argument("--data_dir", default=None)
  parser.add_argument("--coco_version", default=None)
  args, overrides = parser.parse_known_args(argv)
  logging.basicConfig(level=logging.INFO)
  config = config_from_args(parser, args.config, overrides)
  for key in ("num_train_steps", "data_source", "data_dir", "coco_version"):
    if getattr(args, key) is not None:
      config[key] = getattr(args, key)
  if args.mode == "train":
    from xmcgan_image_generation_tpu_torch import train as train_lib
    train_lib.train(config, args.workdir, args.device)
  elif args.mode == "test":
    from xmcgan_image_generation_tpu_torch import evaluate as eval_lib
    eval_lib.evaluate_continuously(config, args.workdir, args.device)
  elif args.mode == "generate":
    from xmcgan_image_generation_tpu_torch import generate as gen_lib
    gen_lib.generate(config, args.workdir, args.device)
  else:
    from xmcgan_image_generation_tpu_torch.utils import serving
    for path in serving.export_from_workdir(config, args.workdir,
                                            device=args.device):
      logging.info("Wrote serving artifact %s", path)


if __name__ == "__main__":
  main()

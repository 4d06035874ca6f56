"""Export a trained generator as a standalone ``torch.export`` serving
artifact (the JAX package's ``tools/export_serving.py``).

Restores a checkpoint from a training workdir and writes, for each weight
set (EMA and/or normal), an ``ExportedProgram`` (``.pt2``) and a JSON
sidecar describing its inputs and output.  A consumer runs it with
``torch.export.load(path).module()(sentence_embedding, embedding,
max_len, z)`` and nothing but ``torch``, on the device it was exported
for.  ``--mode=export`` of ``main`` does the same with the defaults; this
form takes the configuration as a module of the port's ``configs``.

Usage (defaults: EMA weights, symbolic batch dimension, the card)::

  python -m xmcgan_image_generation_tpu_torch.export_serving \\
      --workdir DIR [--config_module coco_xmc[:variant]] [--step N] \\
      [--batch_size N] [--weights ema|normal|both] [--device cuda|cpu] \\
      [--out DIR] [--quantize int8]
"""

from __future__ import annotations

import argparse
import os

from xmcgan_image_generation_tpu_torch.utils import serving


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--workdir", required=True)
  p.add_argument("--config_module", default="coco_xmc",
                 help="configs/<module>[:variant], e.g. coco_xmc_256")
  p.add_argument("--step", type=int, default=None,
                 help="checkpoint step (default: latest)")
  p.add_argument("--batch_size", type=int, default=0,
                 help="static batch size; 0 = symbolic (any batch)")
  p.add_argument("--weights", choices=("ema", "normal", "both"),
                 default="ema")
  p.add_argument("--device", default="cuda",
                 help="device the artifact is traced for and serves on")
  p.add_argument("--out", default=None,
                 help="output dir (default: {workdir}/serving)")
  p.add_argument("--quantize", choices=("int8",), default=None,
                 help="weight-only quantization (lossy; about 4x smaller "
                      "artifact than float32)")
  args = p.parse_args(argv)
  written = serving.export_from_workdir(
      serving.load_config_module(args.config_module), args.workdir,
      step=args.step, batch_size=args.batch_size or None,
      weights=args.weights, device=args.device, out_dir=args.out,
      quantize=args.quantize)
  for path in written:
    print(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB) + .json")


if __name__ == "__main__":
  main()

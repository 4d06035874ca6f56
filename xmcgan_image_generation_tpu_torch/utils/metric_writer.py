"""Scalars to JSON lines and images to PNG grids (the part of the JAX
package's ``utils/metric_writer.py`` that the port's loops call).

`MetricWriter` appends one JSON object per call, ``{"step": ..., **scalars}``,
to ``{workdir}/metrics.jsonl`` and writes image grids to
``{workdir}/images/{name}_{step:08d}.png``.
"""

from __future__ import annotations

import json
import logging
from typing import Mapping

import numpy as np

from xmcgan_image_generation_tpu_torch.utils import fileio
from xmcgan_image_generation_tpu_torch.utils import image_utils

log = logging.getLogger("xmcgan_torch")


class MetricWriter:
  """Writes scalar dicts to ``metrics.jsonl`` and images to PNGs."""

  def __init__(self, workdir: str):
    self.workdir = workdir
    fileio.makedirs(workdir)
    self._f = open(fileio.join(workdir, "metrics.jsonl"), "a")

  def write_scalars(self, step: int, scalars: Mapping[str, float]) -> None:
    record = {"step": int(step), **{k: float(v) for k, v in scalars.items()}}
    log.info("step %d: %s", step, record)
    self._f.write(json.dumps(record) + "\n")
    self._f.flush()

  def write_images(self, step: int, images: Mapping[str, np.ndarray],
                   max_images: int = 64) -> None:
    fileio.makedirs(fileio.join(self.workdir, "images"))
    for name, batch in images.items():
      path = fileio.join(self.workdir, "images",
                         f"{name}_{int(step):08d}.png")
      image_utils.save_image(np.asarray(batch), path, max_images)

  def close(self) -> None:
    self._f.close()

"""Metric and image writers, running means and periodic reports (the JAX
package's ``utils/metric_writer.py``).

`MetricWriter` appends one JSON object per call, ``{"step": ..., **scalars}``,
to ``{workdir}/metrics.jsonl``, writes image grids to
``{workdir}/images/{name}_{step:08d}.png`` and, as the reference does, the
same scalars and grids as TensorBoard events (`utils.tb_writer`); with
``just_logging`` (every process but the first of a run, as in the JAX
loop) it only logs the scalars.
`MetricAccumulator` keeps the running sums of a logging interval on the
device and reads them to the host once, when the interval's mean is
written.  `ReportProgress` writes ``steps_per_sec`` and
``perf/images_per_sec``; `Profile` captures a few steps with
``torch.profiler``.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from xmcgan_image_generation_tpu_torch.utils import fileio
from xmcgan_image_generation_tpu_torch.utils import image_utils
from xmcgan_image_generation_tpu_torch.utils.tb_writer import EventFileWriter

log = logging.getLogger("xmcgan_torch")


class MetricWriter:
  """Writes scalar dicts to ``metrics.jsonl`` and images to PNGs, and
  both to a TensorBoard event file."""

  def __init__(self, workdir: str, just_logging: bool = False):
    self.workdir = workdir
    self.just_logging = just_logging
    if just_logging:
      return
    fileio.makedirs(workdir)
    self._f = open(fileio.join(workdir, "metrics.jsonl"), "a")
    self._tb = EventFileWriter(workdir)

  def write_scalars(self, step: int, scalars: Mapping[str, float]) -> None:
    scalars = {k: float(v) for k, v in scalars.items()}
    log.info("step %d: %s", step,
             " ".join(f"{k}={v:.4f}" for k, v in scalars.items()))
    if self.just_logging:
      return
    self._f.write(json.dumps({"step": int(step), **scalars}) + "\n")
    self._f.flush()
    self._tb.write_scalars(step, scalars)
    self._tb.flush()

  def write_images(self, step: int, images: Mapping[str, np.ndarray],
                   max_images: int = 64) -> None:
    if self.just_logging:
      return
    fileio.makedirs(fileio.join(self.workdir, "images"))
    for name, batch in images.items():
      path = fileio.join(self.workdir, "images",
                         f"{name}_{int(step):08d}.png")
      grid = image_utils.make_grid(np.asarray(batch), max_images)
      image_utils.save_image(grid, path)
      self._tb.write_image(step, name, grid)
    self._tb.flush()

  def write_hparams(self, hparams: Mapping) -> None:
    log.info("hparams: %s", dict(hparams))
    if self.just_logging:
      return
    fileio.atomic_write(
        fileio.join(self.workdir, "hparams.json"),
        json.dumps({k: _jsonable(v) for k, v in dict(hparams).items()},
                   indent=2, default=str))

  def close(self) -> None:
    if self.just_logging:
      return
    self._f.close()
    self._tb.close()


def _jsonable(v):
  if isinstance(v, (bool, int, float, str, type(None))):
    return v
  return str(v)


class MetricAccumulator:
  """Running mean of per-step scalars between writes.

  Values may be device tensors: their sums stay on the device (one small
  add a step, no synchronization) and reach the host in one copy in
  `compute_and_reset`.
  """

  def __init__(self):
    self._sums: Dict[str, object] = {}
    self._count = 0

  def update(self, metrics: Mapping[str, object]) -> None:
    for k, v in metrics.items():
      if isinstance(v, torch.Tensor):
        v = v.detach().float()
      self._sums[k] = v if k not in self._sums else self._sums[k] + v
    self._count += 1

  def compute_and_reset(self) -> Dict[str, float]:
    if not self._count:
      return {}
    names = [k for k, v in self._sums.items() if isinstance(v, torch.Tensor)]
    values = {k: float(v) for k, v in self._sums.items() if k not in names}
    if names:
      host = torch.stack([self._sums[k] for k in names]).tolist()
      values.update(zip(names, host))
    out = {k: values[k] / self._count for k in self._sums}
    self._sums, self._count = {}, 0
    return out


class Profile:
  """Captures a ``torch.profiler`` trace of a few steps.

  Call once a step: at ``profile_step`` it starts the profiler (the CUDA
  activity too when ``device`` is a CUDA device) and stops it
  ``num_profile_steps`` later, writing to ``{logdir}/plugins/profile`` a
  ``*.pt.trace.json``, which TensorBoard's profiler plugin reads.
  """

  def __init__(self, logdir: str, profile_step: int = 10,
               num_profile_steps: int = 5, device="cpu"):
    self.logdir = fileio.join(logdir, "plugins", "profile")
    self.profile_step = profile_step
    self.num_profile_steps = num_profile_steps
    self.activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
      self.activities.append(torch.profiler.ProfilerActivity.CUDA)
    self._prof = None
    self._done = False

  def __call__(self, step: int) -> None:
    if self._done:
      return
    if self._prof is None and step == self.profile_step:
      self._prof = torch.profiler.profile(
          activities=self.activities,
          on_trace_ready=torch.profiler.tensorboard_trace_handler(
              self.logdir))
      self._prof.__enter__()
    elif (self._prof is not None
          and step >= self.profile_step + self.num_profile_steps):
      self.close()
      log.info("Wrote a torch.profiler trace of steps %d-%d to %s",
               self.profile_step, step, self.logdir)

  def close(self) -> None:
    """Stops a capture still running (the loop ended inside it)."""
    if self._prof is not None:
      self._prof.__exit__(None, None, None)
      self._prof = None
      self._done = True


class ReportProgress:
  """Periodic ``steps_per_sec`` and, given ``images_per_step``,
  ``perf/images_per_sec``, written every ``every_steps``."""

  def __init__(self, every_steps: int = 100,
               num_train_steps: Optional[int] = None,
               writer: Optional[MetricWriter] = None,
               images_per_step: Optional[int] = None):
    self.every_steps = max(1, every_steps)
    self.num_train_steps = num_train_steps
    self.writer = writer
    self.images_per_step = images_per_step
    self._last_time = time.monotonic()
    self._last_step: Optional[int] = None

  def __call__(self, step: int) -> None:
    if self._last_step is None:
      self._last_step, self._last_time = step, time.monotonic()
      return
    if step % self.every_steps:
      return
    now = time.monotonic()
    sps = (step - self._last_step) / max(now - self._last_time, 1e-9)
    frac = (f", {step / self.num_train_steps:.1%}" if self.num_train_steps
            else "")
    scalars = {"steps_per_sec": sps}
    perf = ""
    if self.images_per_step:
      scalars["perf/images_per_sec"] = sps * self.images_per_step
      perf = f", {scalars['perf/images_per_sec']:.1f} img/s"
    log.info("progress: step %d (%.3f steps/sec%s%s)", step, sps, perf, frac)
    if self.writer is not None:
      self.writer.write_scalars(step, scalars)
    self._last_step, self._last_time = step, now

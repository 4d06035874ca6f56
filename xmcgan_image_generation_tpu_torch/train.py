"""Training entry point: builds the state and runs the outer step.

`train` is the port's counterpart of the JAX package's ``train.train``
for the synthetic data source.  It writes one JSON line per step to
``workdir/metrics.jsonl``: the step, the five losses, the step's wall
time in seconds (host clock, from drawing the super-batch until the
device has finished the step) and, within it, ``data_seconds``, the time
taken to draw the super-batch and move it to the device.  `setup` and
`timed_step` are the loop's two halves, for tools that time the step.
Checkpoints, the real-data pipeline, sampling and evaluation are not
ported yet.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from xmcgan_image_generation_tpu_torch.data import synthetic
from xmcgan_image_generation_tpu_torch.engine import xmc_gan
from xmcgan_image_generation_tpu_torch.engine.state import (
    TrainState,
    create_train_state,
)
from xmcgan_image_generation_tpu_torch.engine.step import train_step
from xmcgan_image_generation_tpu_torch.utils.bridge import to_tensors

log = logging.getLogger("xmcgan_torch")

Run = Tuple[TrainState, Dict[str, Any], Iterator[Dict[str, np.ndarray]]]


def setup(config, device: torch.device) -> Run:
  """The state, the additional data and the super-batch stream of a run."""
  if config.data_source != "synthetic":
    raise NotImplementedError(
        f"data_source={config.data_source!r}: only 'synthetic' is ported")
  state = create_train_state(config, device, seed=config.seed)
  additional_data = xmc_gan.create_additional_data(config, device)
  return state, additional_data, synthetic.super_batches(config,
                                                         seed=config.seed)


def timed_step(run: Run, config, device: torch.device
               ) -> Tuple[Dict[str, float], float, float]:
  """Draws the next super-batch, moves it to ``device`` and takes one
  outer step.  Returns the metrics, the seconds until the device has
  finished, and the seconds of those spent on the batch."""
  state, additional_data, batches = run
  start = time.perf_counter()
  batch = to_tensors(next(batches), device)
  data_seconds = time.perf_counter() - start
  _, metrics = train_step(state, batch, config, additional_data)
  if device.type == "cuda":
    torch.cuda.synchronize(device)
  seconds = time.perf_counter() - start
  return {k: float(v) for k, v in metrics.items()}, seconds, data_seconds


def train(config, workdir: str, device="cuda") -> TrainState:
  """Trains for ``config.num_train_steps`` outer steps on ``device`` and
  returns the state."""
  if config.num_train_steps <= 0:
    raise ValueError("num_train_steps must be > 0")
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device; pass device='cpu' to train on the "
                       "CPU")
  os.makedirs(workdir, exist_ok=True)
  run = setup(config, device)
  state = run[0]
  with open(os.path.join(workdir, "metrics.jsonl"), "a") as f:
    for _ in range(config.num_train_steps):
      metrics, seconds, data_seconds = timed_step(run, config, device)
      record = {"step": state.step, **metrics, "seconds": seconds,
                "data_seconds": data_seconds}
      f.write(json.dumps(record) + "\n")
      f.flush()
      log.info("step %d: %s", state.step, record)
  return state

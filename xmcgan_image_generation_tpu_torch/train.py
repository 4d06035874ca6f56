"""Training entry point: builds the state and runs the training loop.

`train` is the port's counterpart of the JAX package's ``train.train``
for the synthetic data source: it resumes from the latest checkpoint in
``workdir/checkpoints``, takes the outer steps, samples image grids with
the normal and EMA weights every ``eval_every_steps`` and at the last
step, checkpoints every ``checkpoint_every_steps`` and at the last step,
and marks ``TRAIN_DONE`` at the end.  It writes one JSON line per step to
``workdir/metrics.jsonl``: the step, the five losses, the step's wall time
in seconds (host clock, from drawing the super-batch until the device has
finished the step) and, within it, ``data_seconds``, the time taken to
draw the super-batch and move it to the device.  Sampling and checkpoints
lie outside that window; each save's seconds and bytes go to
``workdir/checkpoints.jsonl``.  `setup` and `timed_step` are the loop's
two halves, for tools that time the step.  The real-data pipeline is not
ported yet.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Tuple

import torch

from xmcgan_image_generation_tpu_torch.data import synthetic
from xmcgan_image_generation_tpu_torch.engine import xmc_gan
from xmcgan_image_generation_tpu_torch.engine.sampling import generate_batch
from xmcgan_image_generation_tpu_torch.engine.state import (
    TrainState,
    create_train_state,
)
from xmcgan_image_generation_tpu_torch.engine.step import train_step
from xmcgan_image_generation_tpu_torch.utils.bridge import to_tensors
from xmcgan_image_generation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    checkpoints_dir,
)
from xmcgan_image_generation_tpu_torch.utils.metric_writer import MetricWriter
from xmcgan_image_generation_tpu_torch.utils.task_manager import (
    TaskManagerWithCsvResults,
)

log = logging.getLogger("xmcgan_torch")

Run = Tuple[TrainState, Dict[str, Any], synthetic.SyntheticStream]


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


def visualization_batch(config, device) -> Dict[str, torch.Tensor]:
  """The conditions the loop samples from: one sub-batch, drawn once from
  a stream of its own (seed + 1), so that successive grids show the same
  captions."""
  stream = synthetic.SyntheticStream(config, seed=config.seed + 1,
                                     n=config.batch_size)
  return to_tensors(next(stream), device)


def train(config, workdir: str, device="cuda") -> TrainState:
  """Trains up to ``config.num_train_steps`` outer steps on ``device``,
  resuming from ``workdir``'s latest checkpoint, and returns the state."""
  if config.num_train_steps <= 0:
    raise ValueError("num_train_steps must be > 0")
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device; pass device='cpu' to train on the "
                       "CPU")
  os.makedirs(workdir, exist_ok=True)
  run = setup(config, device)
  state, _, batches = run
  ckpt = CheckpointManager(checkpoints_dir(workdir))
  task_manager = TaskManagerWithCsvResults(checkpoints_dir(workdir))
  ckpt.restore_or_initialize(state, batches)
  initial_step = state.step + 1
  writer = MetricWriter(workdir)
  vis_batch = None
  log.info("Starting training loop at step %d.", initial_step)
  for step in range(initial_step, config.num_train_steps + 1):
    is_last = step == config.num_train_steps
    metrics, seconds, data_seconds = timed_step(run, config, device)
    writer.write_scalars(state.step, {**metrics, "seconds": seconds,
                                      "data_seconds": data_seconds})

    if step % config.eval_every_steps == 0 or is_last:
      if vis_batch is None:
        vis_batch = visualization_batch(config, device)
      sample = generate_batch(state, vis_batch, config)
      writer.write_images(step, {
          "generated_image": sample["generated_image"].cpu().numpy(),
          "ema_generated_image": sample["ema_generated_image"].cpu().numpy(),
          "original_image": sample["image"].cpu().numpy(),
      }, max_images=config.show_num)

    if step % config.checkpoint_every_steps == 0 or is_last:
      save_seconds, size = ckpt.save(step, state, batches)
      log.info("checkpoint @%d saved in %.2f s, %d bytes", step,
               save_seconds, size)
      with open(os.path.join(workdir, "checkpoints.jsonl"), "a") as f:
        f.write(json.dumps({"step": step, "seconds": save_seconds,
                            "bytes": size}) + "\n")
  writer.close()
  task_manager.mark_training_done()
  log.info("Finished training at step %d.", state.step)
  return state

"""Training entry point: builds the state and runs the training loop (the
JAX package's ``train.py``).

`train` resumes from the latest checkpoint in ``workdir/checkpoints``,
takes the outer steps on super-batches from the loader of
`data.pipeline.create_datasets` (synthetic examples or COCO TFRecords),
which a `data.prefetch.DevicePrefetcher` moves to the device ahead of the
step (step k takes super-batch k: a fresh run passes over super-batch 0,
which the JAX loop spends on initializing its models), samples image
grids with the normal and EMA weights from the step's first sub-batch
every ``eval_every_steps`` and at the last step, checkpoints every
``checkpoint_every_steps`` and at the last step, and marks
``TRAIN_DONE`` at the end.  ``num_train_steps = -1`` trains for
``num_epochs`` epochs (`compute_num_train_steps`).  A SIGTERM stops the
loop at a step agreed through the workdir (`utils.preemption`), which it
checkpoints before returning without ``TRAIN_DONE``.

Each step writes one JSON line to ``workdir/metrics.jsonl``: the step, the
five losses, ``g_lr`` and ``d_lr`` when the learning rate is scheduled,
``seconds``, the step's wall time (host clock, from asking for the
super-batch until the device has finished the step), and within it
``data_seconds``, the wall time spent blocked waiting for the super-batch:
the input stall, as the JAX package's ``tools/pipeline_bench.py`` measures
it.  Sampling and checkpoints lie outside that window; each save's seconds
and bytes go to ``workdir/checkpoints.jsonl``.  `setup` and `timed_step`
are the loop's two halves, for tools that time the step.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Tuple

import torch

from xmcgan_image_generation_tpu_torch.data import pipeline
from xmcgan_image_generation_tpu_torch.data.prefetch import DevicePrefetcher
from xmcgan_image_generation_tpu_torch.engine import xmc_gan
from xmcgan_image_generation_tpu_torch.engine.sampling import generate_batch
from xmcgan_image_generation_tpu_torch.engine.state import (
    TrainState,
    create_train_state,
    learning_rates,
)
from xmcgan_image_generation_tpu_torch.engine.step import (
    split_batch,
    train_step,
)
from xmcgan_image_generation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    checkpoints_dir,
)
from xmcgan_image_generation_tpu_torch.utils.metric_writer import MetricWriter
from xmcgan_image_generation_tpu_torch.utils.preemption import PreemptionGuard
from xmcgan_image_generation_tpu_torch.utils.task_manager import (
    TaskManagerWithCsvResults,
)

log = logging.getLogger("xmcgan_torch")

Run = Tuple[TrainState, Dict[str, Any], DevicePrefetcher]


def compute_num_train_steps(config, num_train_examples: int) -> int:
  """``num_train_steps``, or when it is -1, ``num_epochs`` epochs of
  ``examples // (batch_size * d_step_per_g_step)`` outer steps (at least
  one a epoch): every outer step takes a super-batch."""
  if config.num_train_steps != -1:
    return config.num_train_steps
  steps_per_epoch = max(
      1, num_train_examples
      // (config.batch_size * config.d_step_per_g_step))
  return steps_per_epoch * config.num_epochs


def setup(config, device: torch.device) -> Tuple[Run, int]:
  """The state, the additional data and the prefetched super-batches of a
  run, and the number of training examples."""
  state = create_train_state(config, device, seed=config.seed)
  additional_data = xmc_gan.create_additional_data(config, device)
  train_loader, _, num_train = pipeline.create_datasets(config,
                                                        seed=config.seed)
  batches = DevicePrefetcher(iter(train_loader), device,
                             size=config.get("prefetch_batches", 2))
  return (state, additional_data, batches), num_train


def timed_step(run: Run, config, device: torch.device
               ) -> Tuple[Dict[str, float], float, float,
                          Dict[str, torch.Tensor]]:
  """Takes the next super-batch and one outer step on it.  Returns the
  metrics, the seconds until the device has finished, the seconds of
  those spent blocked waiting for the batch, and the batch."""
  state, additional_data, batches = run
  start = time.perf_counter()
  batch = next(batches)
  data_seconds = time.perf_counter() - start
  _, metrics = train_step(state, batch, config, additional_data)
  if device.type == "cuda":
    torch.cuda.synchronize(device)
  seconds = time.perf_counter() - start
  return ({k: float(v) for k, v in metrics.items()}, seconds, data_seconds,
          batch)


def train(config, workdir: str, device="cuda") -> TrainState:
  """Trains up to the step count of `compute_num_train_steps` on
  ``device``, resuming from ``workdir``'s latest checkpoint, and returns
  the state (at the preemption step if a SIGTERM stopped it)."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device; pass device='cpu' to train on the "
                       "CPU")
  os.makedirs(workdir, exist_ok=True)
  run, num_train_examples = setup(config, device)
  state, _, batches = run
  num_train_steps = compute_num_train_steps(config, num_train_examples)
  if num_train_steps <= 0:
    raise ValueError(f"num_train_steps must be > 0 or -1, got "
                     f"{config.num_train_steps}")
  log.info("num_train_steps=%d (examples=%d)", num_train_steps,
           num_train_examples)
  ckpt = CheckpointManager(checkpoints_dir(workdir))
  task_manager = TaskManagerWithCsvResults(checkpoints_dir(workdir))
  if ckpt.latest_step() is None:
    # The JAX loop initializes its models from super-batch 0 (its
    # ``template_batch``), so its step k trains on super-batch k.
    next(batches)
  ckpt.restore_or_initialize(state, batches)
  initial_step = state.step + 1
  writer = MetricWriter(workdir)
  g_lr, d_lr = learning_rates(config)
  guard = PreemptionGuard(workdir, initial_step,
                          margin=config.get("preemption_margin", 2))
  guard.install()
  preempted_at = None
  log.info("Starting training loop at step %d.", initial_step)
  try:
    for step in range(initial_step, num_train_steps + 1):
      is_last = step == num_train_steps
      metrics, seconds, data_seconds, batch = timed_step(run, config, device)
      scalars = {**metrics, "seconds": seconds, "data_seconds": data_seconds}
      if callable(g_lr):  # a scheduled rate: make it visible
        scalars["g_lr"] = g_lr(step)
        scalars["d_lr"] = d_lr(step * config.d_step_per_g_step)
      writer.write_scalars(state.step, scalars)

      if step % config.eval_every_steps == 0 or is_last:
        vis_batch = split_batch(batch, config.d_step_per_g_step)[0]
        sample = generate_batch(state, vis_batch, config)
        writer.write_images(step, {
            "generated_image": sample["generated_image"].cpu().numpy(),
            "ema_generated_image":
                sample["ema_generated_image"].cpu().numpy(),
            "original_image": sample["image"].cpu().numpy(),
        }, max_images=config.show_num)

      preempt_now = guard.should_stop(step)
      if step % config.checkpoint_every_steps == 0 or is_last or preempt_now:
        save_seconds, size = ckpt.save(step, state, batches)
        log.info("checkpoint @%d saved in %.2f s, %d bytes", step,
                 save_seconds, size)
        with open(os.path.join(workdir, "checkpoints.jsonl"), "a") as f:
          f.write(json.dumps({"step": step, "seconds": save_seconds,
                              "bytes": size}) + "\n")
      if preempt_now:
        preempted_at = step
        break
  finally:
    guard.uninstall()
    batches.close()
    writer.close()
  if preempted_at is not None:
    log.info("Preempted: stopped and checkpointed at step %d (of %d); "
             "restart to resume.", preempted_at, num_train_steps)
    return state
  guard.cleanup()
  task_manager.mark_training_done()
  log.info("Finished training at step %d.", state.step)
  return state

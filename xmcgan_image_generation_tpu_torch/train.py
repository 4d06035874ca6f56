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

The JAX loop's services write the metrics: every
``log_loss_every_steps`` and at the last step, one JSON line in
``workdir/metrics.jsonl`` (and a TensorBoard event) holds the step and the
interval's means (`utils.metric_writer.MetricAccumulator`) of the five
losses, ``seconds`` and ``data_seconds``, with ``g_lr`` and ``d_lr`` when
the learning rate is scheduled; every ``min(100, log_loss_every_steps)``
steps a line holds ``steps_per_sec`` and ``perf/images_per_sec``
(`ReportProgress`); a fresh run writes ``hparams.json``; ``profile=True``
captures steps 10-15 with ``torch.profiler`` (`Profile`).  ``seconds`` is
a step's wall time on the host clock from asking for the super-batch to
the step's end, and ``data_seconds``, within it, the time blocked waiting
for the super-batch: the input stall, as the JAX package's
``tools/pipeline_bench.py`` measures it.  The loop waits for the device
only at a logging step, so one interval's steps tile its wall time and
the last ends when the device has finished: their mean is the
interval's mean step time.  With ``log_loss_every_steps=1`` every step
ends synchronized.  Sampling and checkpoints lie outside those windows;
each save's seconds and bytes go to ``workdir/checkpoints.jsonl``.
`setup` and `timed_step` are the loop's two halves, for tools that time
the step.

Data parallelism: under ``torchrun --nproc_per_node=N`` (or in processes
that already joined a process group) each process drives one device
(`parallel.mesh.MeshRules`), reads its shard of the records
(`data.pipeline`), and the step gathers the global super-batch and takes
the JAX package's update on N devices (`engine.step`).  The state is
broadcast from process 0 after creation or restore.  Process 0 writes the
metrics, hparams, profile, image grids, the checkpoint and
``TRAIN_DONE``; every process writes its own loader state beside the
checkpoint (`utils.checkpoint`).  A SIGTERM to any process stops every
process at one agreed step (`utils.preemption`, with the process's
rank).
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
from xmcgan_image_generation_tpu_torch.engine import registry
from xmcgan_image_generation_tpu_torch.engine.sampling import generate_batch
from xmcgan_image_generation_tpu_torch.engine.state import (
    TrainState,
    broadcast_state,
    create_train_state,
    learning_rates,
)
from xmcgan_image_generation_tpu_torch.engine.step import (
    split_batch,
    train_step,
)
from xmcgan_image_generation_tpu_torch.parallel import collectives
from xmcgan_image_generation_tpu_torch.parallel import context
from xmcgan_image_generation_tpu_torch.parallel.mesh import MeshRules
from xmcgan_image_generation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    checkpoints_dir,
)
from xmcgan_image_generation_tpu_torch.utils.metric_writer import (
    MetricAccumulator,
    MetricWriter,
    Profile,
    ReportProgress,
)
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
  run, and the number of training examples; raises on a ``model_name``
  other than ``"xmc"``."""
  gan_model = registry.get_gan_algorithm(config)
  state = create_train_state(config, device, seed=config.seed)
  additional_data = gan_model.create_additional_data(config, device)
  train_loader, _, num_train = pipeline.create_datasets(config,
                                                        seed=config.seed)
  batches = DevicePrefetcher(iter(train_loader), device,
                             size=config.get("prefetch_batches", 2))
  return (state, additional_data, batches), num_train


def timed_step(run: Run, config, device: torch.device, sync: bool = True
               ) -> Tuple[Dict[str, torch.Tensor], float, float,
                          Dict[str, torch.Tensor]]:
  """Takes the next super-batch and one outer step on it.  Returns the
  metrics (tensors on the device), the seconds until the step has been
  issued (and, with ``sync``, until the device has finished it), the
  seconds of those spent blocked waiting for the batch, and the batch."""
  state, additional_data, batches = run
  start = time.perf_counter()
  batch = next(batches)
  data_seconds = time.perf_counter() - start
  _, metrics = train_step(state, batch, config, additional_data)
  if sync and device.type == "cuda":
    torch.cuda.synchronize(device)
  seconds = time.perf_counter() - start
  return metrics, seconds, data_seconds, batch


def train(config, workdir: str, device="cuda") -> TrainState:
  """Trains up to the step count of `compute_num_train_steps` on
  ``device`` (``cuda:LOCAL_RANK`` for ``"cuda"``), resuming from
  ``workdir``'s latest checkpoint, and returns the state (at the
  preemption step if a SIGTERM stopped it)."""
  rules = MeshRules.create(config.get("mesh_data", -1),
                           config.get("mesh_model", 1), device=device)
  try:
    return _train(config, workdir, rules.mesh)
  finally:
    rules.shutdown()


def _train(config, workdir: str, mesh) -> TrainState:
  device, is_main = mesh.device, mesh.is_main
  log.info("process %d of %d on %s", mesh.rank, mesh.world, device)
  if config.batch_size % mesh.world:
    raise ValueError(
        f"Global batch size {config.batch_size} must be divisible by the "
        f"data mesh axis ({mesh.world} processes).")
  os.makedirs(workdir, exist_ok=True)
  run, num_train_examples = setup(config, device)
  state, _, batches = run
  num_train_steps = compute_num_train_steps(config, num_train_examples)
  if num_train_steps <= 0:
    raise ValueError(f"num_train_steps must be > 0 or -1, got "
                     f"{config.num_train_steps}")
  log.info("num_train_steps=%d (examples=%d)", num_train_steps,
           num_train_examples)
  ckpt = CheckpointManager(checkpoints_dir(workdir), mesh=mesh)
  task_manager = TaskManagerWithCsvResults(checkpoints_dir(workdir))
  if ckpt.latest_step() is None:
    # The JAX loop initializes its models from super-batch 0 (its
    # ``template_batch``), so its step k trains on super-batch k.
    next(batches)
  ckpt.restore_or_initialize(state, batches)
  broadcast_state(state)
  initial_step = state.step + 1
  writer = MetricWriter(workdir, just_logging=not is_main)
  if initial_step == 1:
    writer.write_hparams(dict(config))
  hooks = [ReportProgress(
      every_steps=min(100, config.log_loss_every_steps),
      num_train_steps=num_train_steps, writer=writer,
      images_per_step=config.batch_size * config.d_step_per_g_step)]
  profile = None
  if is_main and config.get("profile", False):
    profile = Profile(workdir, profile_step=10, num_profile_steps=5,
                      device=device)
    hooks.append(profile)
  acc = MetricAccumulator()
  g_lr, d_lr = learning_rates(config)
  guard = PreemptionGuard(workdir, initial_step,
                          margin=config.get("preemption_margin", 2),
                          process_index=mesh.rank)
  guard.install()
  preempted_at = None
  log.info("Starting training loop at step %d.", initial_step)
  try:
    for step in range(initial_step, num_train_steps + 1):
      is_last = step == num_train_steps
      log_now = step % config.log_loss_every_steps == 0 or is_last
      metrics, seconds, data_seconds, batch = timed_step(
          run, config, device, sync=log_now)
      acc.update({**metrics, "seconds": seconds,
                  "data_seconds": data_seconds})
      for hook in hooks:
        hook(step)

      if log_now:
        scalars = acc.compute_and_reset()
        if callable(g_lr):  # a scheduled rate: make it visible
          scalars["g_lr"] = g_lr(step)
          scalars["d_lr"] = d_lr(step * config.d_step_per_g_step)
        writer.write_scalars(step, scalars)

      if step % config.eval_every_steps == 0 or is_last:
        # The global super-batch's first sub-batch, sampled by process 0
        # alone (G in eval mode runs no collective).
        vis_batch = split_batch(collectives.gather_batch(batch),
                                config.d_step_per_g_step)[0]
        if is_main:
          with context.ambient_mesh(None):
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
        if is_main:
          with open(os.path.join(workdir, "checkpoints.jsonl"), "a") as f:
            f.write(json.dumps({"step": step, "seconds": save_seconds,
                                "bytes": size}) + "\n")
      if preempt_now:
        preempted_at = step
        break
  finally:
    if profile is not None:
      profile.close()
    guard.uninstall()
    batches.close()
    writer.close()
  if preempted_at is not None:
    log.info("Preempted: stopped and checkpointed at step %d (of %d); "
             "restart to resume.", preempted_at, num_train_steps)
    return state
  guard.cleanup()
  if is_main:
    task_manager.mark_training_done()
  log.info("Finished training at step %d.", state.step)
  return state

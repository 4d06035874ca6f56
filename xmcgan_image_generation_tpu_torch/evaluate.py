"""Continuous-evaluation service (the JAX package's ``evaluate.py``, the
reference's ``--mode=test`` path).

Computes the real images' Inception statistics once, then polls the
training workdir's checkpoints, scores each (FID and IS with the normal
and EMA weights, mean and std over ``eval_avg_num`` repeats), appends one
row per checkpoint to ``checkpoints/scores.csv`` and the scalars to
``metrics.jsonl``, and returns on timeout or once ``TRAIN_DONE`` is there
and every checkpoint is scored.  The batches come from the eval loader of
`data.pipeline.create_datasets` (the validation records, or the synthetic
source): the real pool is its first ``eval_num`` images, and its batches
also give the generator its conditions, as in the JAX package.

Under ``torchrun --nproc_per_node=N`` the service is one job of N
processes, one device each, as the JAX package's is one SPMD job: each
process reads its shard of every global eval batch, restores each
checkpoint itself, and scores its rows; the statistics merge once a pass
(`utils.fid`), so every process computes the same FID and IS.  Process 0
alone lists the checkpoint directory and broadcasts each step to the
others (`_synchronized_steps`), and alone appends ``scores.csv`` and
writes the metrics.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from xmcgan_image_generation_tpu_torch.data import pipeline
from xmcgan_image_generation_tpu_torch.data.prefetch import DevicePrefetcher
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.parallel import collectives
from xmcgan_image_generation_tpu_torch.parallel import context
from xmcgan_image_generation_tpu_torch.parallel.mesh import MeshRules
from xmcgan_image_generation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    checkpoints_dir,
)
from xmcgan_image_generation_tpu_torch.utils.eval_metrics import EvalMetric
from xmcgan_image_generation_tpu_torch.utils.metric_writer import MetricWriter
from xmcgan_image_generation_tpu_torch.utils.task_manager import (
    TaskManagerWithCsvResults,
)

log = logging.getLogger("xmcgan_torch")

# Control values process 0 broadcasts; checkpoint steps are >= 0.
_SERVICE_DONE = -1
_HEARTBEAT = -2
# Seconds between process 0's heartbeats while it polls the checkpoints.
HEARTBEAT_INTERVAL = 5.0


def _synchronized_steps(task_manager, timeout: float,
                        heartbeat_interval: float = HEARTBEAT_INTERVAL,
                        worker_deadline: Optional[float] = None):
  """Yields the checkpoint steps to evaluate, the same on every process.

  Processes that each listed the directory would race: process 0 could
  score a checkpoint and append ``scores.csv`` before process 1 lists it,
  and wait alone in the statistics' merge.  So process 0 alone polls, and
  broadcasts each step, then ``_SERVICE_DONE``.  While it polls it
  broadcasts ``_HEARTBEAT`` every ``heartbeat_interval`` seconds, so that
  no collective of the control group waits longer than that however far
  apart checkpoints land.  The other processes never list the directory;
  each broadcast they wait for is bounded by ``worker_deadline`` (by
  default ``max(12 x heartbeat_interval, 60 s)``), after which they raise:
  a dead process 0 fails the job instead of hanging it.
  """
  mesh = context.active_mesh()
  if mesh is None or mesh.world == 1:
    yield from task_manager.unevaluated_checkpoints(timeout=timeout)
    return
  if worker_deadline is None:
    worker_deadline = max(12.0 * heartbeat_interval, 60.0)
  if mesh.rank == 0:
    for step in task_manager.unevaluated_checkpoints(
        timeout=timeout, poll_interval=heartbeat_interval,
        poll_callback=lambda: collectives.broadcast_int(
            _HEARTBEAT, tag="heartbeat")):
      collectives.broadcast_int(step, tag="step")
      yield step
    collectives.broadcast_int(_SERVICE_DONE, tag="step")
    return
  while True:
    step = collectives.broadcast_int(0, deadline=worker_deadline, tag="step")
    if step == _HEARTBEAT:
      continue
    if step < 0:
      return
    yield step


def eval_stream(config, device):
  """This process's eval loader batches (``eval_batch_size`` divided over
  the processes), moved to ``device`` ahead by a `DevicePrefetcher`, or
  numpy batches when ``return_text`` asks for the captions' text, which
  stays on the host.  Close it when done."""
  _, eval_loader, _ = pipeline.create_datasets(config, seed=config.seed)
  batches = iter(eval_loader)
  if config.return_text:
    return batches
  return DevicePrefetcher(batches, device,
                          size=config.get("prefetch_batches", 2))


def evaluate_continuously(config, workdir: str, device="cuda",
                          timeout: float = 24 * 3600) -> EvalMetric:
  """Runs the checkpoint-polling FID/IS service against ``workdir`` on
  ``device`` (``cuda:LOCAL_RANK`` for ``"cuda"``), over the processes of
  the run; returns this process's `EvalMetric`, whose timings describe
  the last checkpoint scored."""
  rules = MeshRules.create(config.get("mesh_data", -1),
                           config.get("mesh_model", 1), device=device)
  try:
    # Every process is here before the first collective of the service,
    # whatever its start-up took.
    collectives.host_barrier()
    batches = eval_stream(config, rules.mesh.device)
    try:
      return _serve(config, workdir, rules.mesh, timeout, batches)
    finally:
      batches.close()
  finally:
    rules.shutdown()


def _serve(config, workdir: str, mesh, timeout: float, batches
           ) -> EvalMetric:
  device = mesh.device
  eval_metric = EvalMetric(batches, config, device)
  log.info("Real-image statistics took %.2f s", eval_metric.real_seconds)
  ckpt_dir = checkpoints_dir(workdir)
  task_manager = TaskManagerWithCsvResults(ckpt_dir)
  writer = MetricWriter(workdir, just_logging=not mesh.is_main)
  state = create_train_state(config, device, seed=config.seed)
  ckpt = CheckpointManager(ckpt_dir)
  rng = torch.Generator(device=device).manual_seed(config.seed)
  for step in _synchronized_steps(task_manager, timeout,
                                  heartbeat_interval=HEARTBEAT_INTERVAL):
    log.info("Evaluating checkpoint at step %d", step)
    ckpt.restore(step, state)
    (fid, fid_std, inception_score, inception_score_std,
     ema_fid, ema_fid_std, ema_is, ema_is_std) = (
         eval_metric.calculate_inception_fid(state, rng))
    result = {
        "eval/fid": fid,
        "eval/fid_std": fid_std,
        "eval/inception_score": inception_score,
        "eval/inception_score_std": inception_score_std,
        "eval/ema_fid": ema_fid,
        "eval/ema_fid_std": ema_fid_std,
        "eval/ema_inception_score": ema_is,
        "eval/ema_inception_score_std": ema_is_std,
    }
    if mesh.is_main:
      task_manager.add_eval_result(step, result)
    writer.write_scalars(step, result)
    log.info("Step %d scored in %.2f s (%d generated images)", step,
             eval_metric.last_seconds, eval_metric.last_images)
  writer.close()
  log.info("Evaluation service finished.")
  return eval_metric

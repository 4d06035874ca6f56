"""Continuous-evaluation service, one process (the JAX package's
``evaluate.py``, the reference's ``--mode=test`` path).

Computes the real images' Inception statistics once, then polls the
training workdir's checkpoints, scores each (FID and IS with the normal
and EMA weights, mean and std over ``eval_avg_num`` repeats), appends one
row per checkpoint to ``checkpoints/scores.csv`` and the scalars to
``metrics.jsonl``, and returns on timeout or once ``TRAIN_DONE`` is there
and every checkpoint is scored.  The batches come from the eval loader of
`data.pipeline.create_datasets` (the validation records, or the synthetic
source): the real pool is its first ``eval_num`` images, and its batches
also give the generator its conditions, as in the JAX package.
"""

from __future__ import annotations

import logging

import torch

from xmcgan_image_generation_tpu_torch.data import pipeline
from xmcgan_image_generation_tpu_torch.data.prefetch import DevicePrefetcher
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
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


def eval_stream(config, device):
  """The eval loader's batches of ``eval_batch_size`` examples, moved to
  ``device`` ahead by a `DevicePrefetcher`, or numpy batches when
  ``return_text`` asks for the captions' text, which stays on the host.
  Close it when done."""
  _, eval_loader, _ = pipeline.create_datasets(config, seed=config.seed)
  batches = iter(eval_loader)
  if config.return_text:
    return batches
  return DevicePrefetcher(batches, device,
                          size=config.get("prefetch_batches", 2))


def evaluate_continuously(config, workdir: str, device="cuda",
                          timeout: float = 24 * 3600) -> EvalMetric:
  """Runs the checkpoint-polling FID/IS service against ``workdir`` on
  ``device``; returns the `EvalMetric`, whose timings describe the last
  checkpoint scored."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device; pass device='cpu' to evaluate on "
                       "the CPU")
  batches = eval_stream(config, device)
  try:
    return _serve(config, workdir, device, timeout, batches)
  finally:
    batches.close()


def _serve(config, workdir: str, device: torch.device, timeout: float,
           batches) -> EvalMetric:
  eval_metric = EvalMetric(batches, config, device)
  log.info("Real-image statistics took %.2f s", eval_metric.real_seconds)
  ckpt_dir = checkpoints_dir(workdir)
  task_manager = TaskManagerWithCsvResults(ckpt_dir)
  writer = MetricWriter(workdir)
  state = create_train_state(config, device, seed=config.seed)
  ckpt = CheckpointManager(ckpt_dir)
  rng = torch.Generator(device=device).manual_seed(config.seed)
  for step in task_manager.unevaluated_checkpoints(timeout=timeout):
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
    task_manager.add_eval_result(step, result)
    writer.write_scalars(step, result)
    log.info("Step %d scored in %.2f s (%d generated images)", step,
             eval_metric.last_seconds, eval_metric.last_images)
  writer.close()
  log.info("Evaluation service finished.")
  return eval_metric

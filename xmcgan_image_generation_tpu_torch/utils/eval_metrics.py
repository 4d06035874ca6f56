"""FID and Inception Score of generator checkpoints (the JAX package's
``utils/eval_metrics.py``, for one device).

The real images' Inception statistics are computed once; then each
checkpoint generates ``eval_num`` images with its normal and its EMA
weights, runs them through InceptionV3 and reports FID and IS averaged
over ``eval_avg_num`` repeats.  Inception weights load from a converted
``.npz`` when ``config.inception_ckpt_path`` is set; otherwise the tower
is randomly initialized from a fixed seed, which tracks relative progress
but is not comparable to published FID.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from xmcgan_image_generation_tpu_torch.data.prefetch import numeric_tensors
from xmcgan_image_generation_tpu_torch.engine.sampling import generate_batch
from xmcgan_image_generation_tpu_torch.engine.state import TrainState
from xmcgan_image_generation_tpu_torch.models.inception_v3 import InceptionV3
from xmcgan_image_generation_tpu_torch.ops.images import image_to_float
from xmcgan_image_generation_tpu_torch.utils import fid as fid_lib
from xmcgan_image_generation_tpu_torch.utils import inception_weights

log = logging.getLogger("xmcgan_torch")

INCEPTION_SIZE = 299
POOL_DIM = 2048
NUM_CLASSES = 1000

Features = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def make_inception_fn(ckpt_path: Optional[str] = None,
                      device=None) -> Features:
  """The ``images -> (pool, probs)`` feature function on ``device``.

  Images are NHWC floats in [0, 1] of any size; they are resized to 299^2
  bilinearly (half-pixel centers, as ``jax.image.resize``) and mapped to
  [-1, 1].
  """
  model = inception_weights.load_or_init(InceptionV3(device=device),
                                         ckpt_path)

  def features(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    images = images.float()
    if images.shape[1:3] != (INCEPTION_SIZE, INCEPTION_SIZE):
      # No antialiasing: every image size of the configurations (at most
      # 256) grows to 299, where ``jax.image.resize`` does not antialias
      # either (utils/pretrained.py shrinks 256 -> 224 and must).
      images = F.interpolate(
          images.permute(0, 3, 1, 2), size=(INCEPTION_SIZE, INCEPTION_SIZE),
          mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    images = torch.clamp(images * 2.0 - 1.0, -1.0, 1.0)
    with torch.no_grad():
      pool, logits = model(images)
    return pool, torch.softmax(logits, dim=-1)

  return features


class EvalMetric:
  """FID and IS of generator checkpoints against a pool of real images.

  ``eval_iter`` yields batches of ``eval_batch_size`` examples (the
  loader's keys), numpy or tensors on the device; the real pool is its
  first ``eval_num`` images.
  Host-clock timings: ``real_seconds`` of the real statistics; of the last
  `calculate_inception_fid`, ``last_seconds`` in all and
  ``last_generate_seconds`` of those spent generating the images and
  running Inception on them (the rest is the host's FID and IS math), and
  ``last_images``, the generated images it scored (both weight sets).
  """

  def __init__(self, eval_iter: Iterator[Dict[str, np.ndarray]], config,
               device=None, num_splits: int = 1,
               inception_ckpt_path: Optional[str] = None):
    self.config = config
    self.eval_iter = eval_iter
    self.device = torch.device(device) if device is not None else None
    self.eval_num = config.eval_num
    self.avg_num = config.eval_avg_num
    self.num_splits = num_splits
    ckpt = inception_ckpt_path or config.get("inception_ckpt_path", "")
    self._inception = make_inception_fn(ckpt or None, self.device)
    self.last_seconds = self.last_generate_seconds = 0.0
    self.last_images = 0
    start = time.perf_counter()
    self._real_mu, self._real_sigma = self._compute_real_statistics()
    self.real_seconds = time.perf_counter() - start

  def _next_batch(self) -> Dict[str, torch.Tensor]:
    return numeric_tensors(next(self.eval_iter), self.device)

  def _compute_real_statistics(self) -> Tuple[np.ndarray, np.ndarray]:
    """The real images' Inception pool statistics, computed once."""
    log.info("Computing real-image Inception statistics over %d samples",
             self.eval_num)
    stats = fid_lib.StreamingGaussianStats(POOL_DIM)
    seen = 0
    while seen < self.eval_num:
      pool, _ = self._inception(image_to_float(self._next_batch()["image"]))
      take = min(pool.shape[0], self.eval_num - seen)
      stats.update(pool, take)
      seen += take
    return stats.compute()

  def _generated_statistics(self, state: TrainState,
                            rng: Optional[torch.Generator]):
    """One pass of ``eval_num`` generated images -> (FID stats, IS) for
    the normal and the EMA weights."""
    pool_stats = {k: fid_lib.StreamingGaussianStats(POOL_DIM)
                  for k in ("normal", "ema")}
    is_stats = {k: fid_lib.StreamingInceptionScore(
        NUM_CLASSES, self.num_splits, self.eval_num)
        for k in ("normal", "ema")}
    seen = 0
    while seen < self.eval_num:
      out = generate_batch(state, self._next_batch(), self.config, rng)
      take = min(out["generated_image"].shape[0], self.eval_num - seen)
      for key, images in (("normal", out["generated_image"]),
                          ("ema", out["ema_generated_image"])):
        pool, probs = self._inception(images)
        pool_stats[key].update(pool, take)
        is_stats[key].update(probs, take)
      seen += take
      self.last_images += 2 * take
    return pool_stats, is_stats

  def calculate_inception_fid(self, state: TrainState,
                              rng: Optional[torch.Generator] = None
                              ) -> Tuple[float, ...]:
    """FID/IS mean and std over ``eval_avg_num`` repeats, normal and EMA:
    ``(fid, fid_std, is, is_std, ema_fid, ema_fid_std, ema_is,
    ema_is_std)``."""
    start = time.perf_counter()
    self.last_images = 0
    self.last_generate_seconds = 0.0
    fids = {"normal": [], "ema": []}
    iss = {"normal": [], "ema": []}
    for _ in range(self.avg_num):
      t0 = time.perf_counter()
      pool_stats, is_stats = self._generated_statistics(state, rng)
      self.last_generate_seconds += time.perf_counter() - t0
      for key in ("normal", "ema"):
        mu, sigma = pool_stats[key].compute()
        fids[key].append(fid_lib.frechet_distance(
            mu, sigma, self._real_mu, self._real_sigma))
        iss[key].append(is_stats[key].compute()[0])
    self.last_seconds = time.perf_counter() - start
    return (
        float(np.mean(fids["normal"])), float(np.std(fids["normal"])),
        float(np.mean(iss["normal"])), float(np.std(iss["normal"])),
        float(np.mean(fids["ema"])), float(np.std(fids["ema"])),
        float(np.mean(iss["ema"])), float(np.std(iss["ema"])),
    )

"""FID and Inception Score with streaming statistics (the JAX package's
``utils/fid.py``, for one process).

Feature batches (tensors on any device, or numpy) are pulled to the host
and accumulated in float64: over 30000 x 2048 pools the one-pass
``E[XX^T] - mu mu^T`` formula loses digits in float32.  The host product
is one ``dim x dim`` GEMM per batch.  The JAX package's per-process
shard walk and cross-process sum wait for multi-GPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _host_rows(features, count: Optional[int] = None) -> np.ndarray:
  """The first ``count`` rows (all without it) as float64 numpy."""
  if isinstance(features, torch.Tensor):
    features = features.detach().to("cpu", torch.float64).numpy()
  feats = np.asarray(features, np.float64)
  if count is not None and int(count) < feats.shape[0]:
    feats = feats[:int(count)]
  return feats


class StreamingGaussianStats:
  """Running mean and covariance over feature batches.

  ``cov`` matches ``np.cov(x, rowvar=False)`` (ddof=1) at float64
  precision.
  """

  def __init__(self, dim: int):
    self._sum = np.zeros((dim,), np.float64)
    self._outer = np.zeros((dim, dim), np.float64)
    self._count = 0

  def update(self, features, count: Optional[int] = None) -> None:
    """Adds a ``[n, dim]`` batch (only its first ``count`` rows when given,
    to trim the last partial batch)."""
    feats = _host_rows(features, count)
    self._sum += feats.sum(axis=0)
    self._outer += feats.T @ feats
    self._count += feats.shape[0]

  def compute(self) -> Tuple[np.ndarray, np.ndarray]:
    """``(mu, sigma)`` of what was added."""
    n = self._count
    if n < 2:
      raise ValueError(f"Need >= 2 samples, got {n}")
    mu = self._sum / n
    sigma = (self._outer - n * np.outer(mu, mu)) / (n - 1)
    return mu, sigma


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
  """||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), retrying with ``eps`` on
  the diagonal when the product is near-singular."""
  from scipy import linalg

  mu1 = np.atleast_1d(mu1)
  mu2 = np.atleast_1d(mu2)
  sigma1 = np.atleast_2d(sigma1)
  sigma2 = np.atleast_2d(sigma2)
  if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
    raise ValueError("Statistics shapes do not match")

  diff = mu1 - mu2
  # scipy >= 1.18 drops sqrtm's `disp` argument (and the errest return);
  # non-finite results are detected from the matrix itself either way.
  with np.errstate(all="ignore"):
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
  if isinstance(covmean, tuple):  # older scipy with disp semantics
    covmean = covmean[0]
  if not np.isfinite(covmean).all():
    offset = np.eye(sigma1.shape[0]) * eps
    covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
  if np.iscomplexobj(covmean):
    if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
      raise ValueError(
          f"Imaginary component {np.max(np.abs(covmean.imag))}")
    covmean = covmean.real
  return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
               - 2 * np.trace(covmean))


def calculate_fid(pool1: np.ndarray, pool2: np.ndarray) -> float:
  """FID between two whole feature matrices."""
  mu1, mu2 = np.mean(pool1, axis=0), np.mean(pool2, axis=0)
  s1 = np.cov(pool1, rowvar=False)
  s2 = np.cov(pool2, rowvar=False)
  return frechet_distance(mu1, s1, mu2, s2)


class StreamingInceptionScore:
  """Running split-KL Inception Score over probability batches: each split
  needs only ``sum(p log p)`` and ``sum(p)``, kept in float64."""

  def __init__(self, num_classes: int = 1000, num_splits: int = 1,
               total: Optional[int] = None):
    self.num_splits = num_splits
    self.total = total
    self._split_of = (lambda i: 0) if num_splits == 1 else (
        lambda i: min(i * num_splits // max(total, 1), num_splits - 1))
    self._plogp = np.zeros((num_splits,), np.float64)
    self._psum = np.zeros((num_splits, num_classes), np.float64)
    self._counts = np.zeros((num_splits,), np.int64)
    self._seen = 0

  def update(self, probs, count: Optional[int] = None) -> None:
    """Adds a ``[n, classes]`` batch of softmax probabilities, all to the
    split of its first row."""
    n = probs.shape[0] if count is None else int(count)
    local = _host_rows(probs, n)
    split = self._split_of(self._seen)
    self._plogp[split] += np.sum(local * np.log(local + 1e-16))
    self._psum[split] += local.sum(axis=0)
    self._counts[split] += local.shape[0]
    self._seen += n

  def compute(self) -> Tuple[float, float]:
    """Mean and standard deviation of the score over the splits."""
    scores = []
    for s in range(self.num_splits):
      n = int(self._counts[s])
      if not n:
        continue
      mean_p = self._psum[s] / n
      mean_plogp = float(self._plogp[s]) / n
      kl = mean_plogp - float(np.sum(mean_p * np.log(mean_p + 1e-16)))
      scores.append(np.exp(kl))
    return float(np.mean(scores)), float(np.std(scores))

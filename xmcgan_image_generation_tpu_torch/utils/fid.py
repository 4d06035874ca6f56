"""FID and Inception Score with streaming statistics (the JAX package's
``utils/fid.py``).

Feature batches (tensors on any device, or numpy) are pulled to the host
and accumulated in float64: over 30000 x 2048 pools the one-pass
``E[XX^T] - mu mu^T`` formula loses digits in float32.  The host product
is one ``dim x dim`` GEMM per batch.

Over a process group (the ambient mesh, `parallel.context`) a batch is
this process's rows of a global batch, process-major, as the eval
loader's shards give them (`data.pipeline.create_datasets`): ``count``
and the Inception Score's splits are in *global* rows, each process
accumulates only its own rows (`local_rows`), and ``compute`` merges the
sums once, through `parallel.collectives.host_sum`, never per batch.  A
process whose rows are all cut away still joins every merge.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from xmcgan_image_generation_tpu_torch.parallel import collectives
from xmcgan_image_generation_tpu_torch.parallel import context


def _world_rank(mesh=None) -> Tuple[int, int]:
  mesh = mesh if mesh is not None else context.active_mesh()
  return (1, 0) if mesh is None else (mesh.world, mesh.rank)


def local_rows(features, count: Optional[int] = None, mesh=None
               ) -> np.ndarray:
  """This process's rows of a process-major global batch, as float64
  numpy, kept only where they fall within its first ``count`` global rows
  (all of them without ``count``): with ``b`` rows a process, process
  ``r`` keeps ``clamp(count - r * b, 0, b)``, the JAX package's
  ``_rows_from_shards`` rule.  ``mesh`` defaults to the ambient one;
  without a group the rows are the whole batch."""
  if isinstance(features, torch.Tensor):
    features = features.detach().to("cpu", torch.float64).numpy()
  feats = np.asarray(features, np.float64)
  if count is None:
    return feats
  return feats[:kept_rows(feats.shape[0], count, mesh)]


def kept_rows(rows: int, count: int, mesh=None) -> int:
  """How many of this process's ``rows`` fall within the first ``count``
  global rows (`local_rows`)."""
  _, rank = _world_rank(mesh)
  return min(max(int(count) - rank * int(rows), 0), int(rows))


def global_rows(features) -> int:
  """The rows of the global batch whose local rows ``features`` holds."""
  world, _ = _world_rank()
  return int(features.shape[0]) * world


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
    """Adds this process's rows of a ``[n, dim]`` global batch (only those
    within its first ``count`` global rows when given, to trim the last
    partial batch)."""
    feats = local_rows(features, count)
    self._sum += feats.sum(axis=0)
    self._outer += feats.T @ feats
    self._count += feats.shape[0]

  def compute(self) -> Tuple[np.ndarray, np.ndarray]:
    """``(mu, sigma)`` of what every process added."""
    total_sum, total_outer, n = collectives.host_sum(
        self._sum, self._outer, np.int64(self._count))
    n = int(n)
    if n < 2:
      raise ValueError(f"Need >= 2 samples, got {n}")
    mu = total_sum / n
    sigma = (total_outer - n * np.outer(mu, mu)) / (n - 1)
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
    """Adds this process's rows of a ``[n, classes]`` global batch of
    softmax probabilities (those within its first ``count`` global rows
    when given), all to the split of the batch's first global row."""
    n = global_rows(probs) if count is None else int(count)
    local = local_rows(probs, n)
    split = self._split_of(self._seen)
    self._plogp[split] += np.sum(local * np.log(local + 1e-16))
    self._psum[split] += local.sum(axis=0)
    self._counts[split] += local.shape[0]
    self._seen += n

  def compute(self) -> Tuple[float, float]:
    """Mean and standard deviation of the score over the splits, of what
    every process added."""
    plogp, psum, counts = collectives.host_sum(self._plogp, self._psum,
                                               self._counts)
    scores = []
    for s in range(self.num_splits):
      n = int(counts[s])
      if not n:
        continue
      mean_p = psum[s] / n
      mean_plogp = float(plogp[s]) / n
      kl = mean_plogp - float(np.sum(mean_p * np.log(mean_p + 1e-16)))
      scores.append(np.exp(kl))
    return float(np.mean(scores)), float(np.std(scores))

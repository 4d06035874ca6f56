"""Pooling and resampling (the JAX package's ``ops/pooling.py``).

These run inside the conv stacks, so they take NCHW tensors (the JAX
functions take NHWC).  `tf_avg_pool` has the JAX function's two forms:
one pass where no window overlaps padding, and the two-pass TF-SAME form
(a window sum over zero padding divided by the count of real cells in the
window) that InceptionV3's 3x3 SAME pools need.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _no_padding_needed(size: int, window: int, stride: int) -> bool:
  out = -(-size // stride)
  return (out - 1) * stride + window <= size


def _same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
  """TF "SAME" padding (low, high) of one spatial axis."""
  out = -(-size // stride)
  total = max((out - 1) * stride + window - size, 0)
  return total // 2, total - total // 2


def tf_avg_pool(x: torch.Tensor, window_shape: Sequence[int],
                strides: Sequence[int], padding: str) -> torch.Tensor:
  """TF-semantics 2-D average pooling of an NCHW tensor (padding cells
  excluded from the mean)."""
  padding = padding.upper()
  window, strides = tuple(window_shape), tuple(strides)
  spatial = x.shape[2:]
  if padding == "VALID" or all(
      _no_padding_needed(s, w, st)
      for s, w, st in zip(spatial, window, strides)):
    return F.avg_pool2d(x, window, strides)
  (pt, pb), (pl, pr) = (_same_pads(s, w, st)
                        for s, w, st in zip(spatial, window, strides))
  pads = (pl, pr, pt, pb)
  pool_sum = F.avg_pool2d(F.pad(x, pads), window, strides,
                          divisor_override=1)
  ones = torch.ones((1, 1) + tuple(spatial), dtype=x.dtype, device=x.device)
  pool_cnt = F.avg_pool2d(F.pad(ones, pads), window, strides,
                          divisor_override=1)
  return pool_sum / pool_cnt


def upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
  """Nearest-neighbor spatial upsampling of an NCHW tensor."""
  n, c, h, w = x.shape
  x = x[:, :, :, None, :, None].expand(n, c, h, factor, w, factor)
  return x.reshape(n, c, h * factor, w * factor)


def dsample(x: torch.Tensor) -> torch.Tensor:
  """2x2 stride-2 average downsample of an NCHW tensor."""
  return tf_avg_pool(x, (2, 2), strides=(2, 2), padding="SAME")

"""Pooling and resampling (the JAX package's ``ops/pooling.py``).

These run inside the conv stacks, so they take NCHW tensors (the JAX
functions take NHWC).  Only the no-padding form of `tf_avg_pool` is here:
the two-pass TF-SAME form, which InceptionV3 needs, comes with the
Inception port.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _no_padding_needed(size: int, window: int, stride: int) -> bool:
  out = -(-size // stride)
  return (out - 1) * stride + window <= size


def tf_avg_pool(x: torch.Tensor, window_shape: Sequence[int],
                strides: Sequence[int], padding: str) -> torch.Tensor:
  """TF-semantics 2-D average pooling of an NCHW tensor.

  Takes the case where no window overlaps padding ("VALID", or "SAME" on
  sizes where SAME pads nothing), in which the mean has a constant
  denominator.  Raises on the padded case.
  """
  padding = padding.upper()
  spatial = x.shape[2:]
  if padding != "VALID" and not all(
      _no_padding_needed(s, w, st)
      for s, w, st in zip(spatial, window_shape, strides)):
    raise NotImplementedError(
        "tf_avg_pool with SAME padding that pads is not ported yet")
  return F.avg_pool2d(x, tuple(window_shape), tuple(strides))


def upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
  """Nearest-neighbor spatial upsampling of an NCHW tensor."""
  n, c, h, w = x.shape
  x = x[:, :, :, None, :, None].expand(n, c, h, factor, w, factor)
  return x.reshape(n, c, h * factor, w * factor)


def dsample(x: torch.Tensor) -> torch.Tensor:
  """2x2 stride-2 average downsample of an NCHW tensor."""
  return tf_avg_pool(x, (2, 2), strides=(2, 2), padding="SAME")

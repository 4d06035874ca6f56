"""Bilinear resizing of uint8 images, bit for bit as Pillow's
``Image.resize(size, Image.BILINEAR)`` (libImaging/Resample.c).

For each axis whose size changes, with ``scale = in / out`` and
``fscale = max(scale, 1)``: output sample ``x`` reads the inputs
``[xmin, xmin + count)`` around ``center = (x + 0.5) * scale`` within a
support of ``fscale``, weighted ``1 - |(j + xmin - center + 0.5) / fscale|``
(clamped at 0), normalized in double precision and rounded half away from
zero to 22-bit fixed point.  Each sum starts at ``1 << 21`` and its top
bits, clipped to 0..255, are the output.  The horizontal pass runs first,
over only the rows that the vertical pass reads.

`resize_uint8` runs the helper of ``csrc/host/fastio.cpp``;
`resize_uint8_plain` is the same algorithm in numpy, against which the
tests hold it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from xmcgan_image_generation_tpu_torch.data import native

PRECISION_BITS = 32 - 8 - 2


def coefficients(in_size: int, out_size: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
  """``(bounds [out, 2], k [out, ksize])``: each output sample's first
  input sample and count, and its fixed-point weights (0 past the
  count)."""
  scale = in_size / out_size
  fscale = max(scale, 1.0)
  support = fscale
  ksize = int(math.ceil(support)) * 2 + 1
  weights = np.zeros((out_size, ksize), np.float64)
  bounds = np.zeros((out_size, 2), np.int64)
  for xx in range(out_size):
    center = (xx + 0.5) * scale
    ss = 1.0 / fscale
    xmin = max(int(center - support + 0.5), 0)
    xmax = min(int(center + support + 0.5), in_size) - xmin
    w = [max(1.0 - abs((x + xmin - center + 0.5) * ss), 0.0)
         for x in range(xmax)]
    total = sum(w)
    if total != 0.0:
      w = [v / total for v in w]
    weights[xx, :xmax] = w
    bounds[xx] = xmin, xmax
  fixed = np.where(weights < 0, -0.5 + weights * (1 << PRECISION_BITS),
                   0.5 + weights * (1 << PRECISION_BITS))
  return bounds, np.trunc(fixed).astype(np.int64)


def _pass(image: np.ndarray, bounds: np.ndarray, k: np.ndarray
          ) -> np.ndarray:
  """Resamples axis 1 of ``image`` [rows, n, C] with these coefficients."""
  n = image.shape[1]
  idx = np.minimum(bounds[:, :1] + np.arange(k.shape[1]), n - 1)
  gathered = image[:, idx, :].astype(np.int64)          # [rows, out, k, C]
  total = np.einsum("rokc,ok->roc", gathered, k) + (1 << (PRECISION_BITS - 1))
  return np.clip(np.maximum(total, 0) >> PRECISION_BITS, 0, 255).astype(
      np.uint8)


def resize_uint8_plain(image: np.ndarray, height: int, width: int
                       ) -> np.ndarray:
  """numpy version of `resize_uint8`."""
  in_h, in_w = image.shape[:2]
  if (in_h, in_w) == (height, width):
    return image.copy()
  image = image.reshape(in_h, in_w, -1)
  out = image
  if in_w != width:
    bounds_h, k_h = coefficients(in_w, width)
    rows = slice(None)
    if in_h != height:
      bounds_v, _ = coefficients(in_h, height)
      rows = slice(int(bounds_v[0, 0]), int(bounds_v[-1].sum()))
    out = _pass(image[rows], bounds_h, k_h)
  if in_h != height:
    bounds_v, k_v = coefficients(in_h, height)
    if in_w != width:
      bounds_v = bounds_v - [bounds_v[0, 0], 0]
    out = _pass(out.transpose(1, 0, 2), bounds_v, k_v).transpose(1, 0, 2)
  return np.ascontiguousarray(out)


def resize_uint8(image: np.ndarray, height: int, width: int) -> np.ndarray:
  """Resizes the uint8 image ``image`` [H, W, C] to [height, width, C]
  (through the host helper)."""
  image = np.ascontiguousarray(image, np.uint8)
  in_h, in_w, channels = image.shape
  out = np.empty((height, width, channels), np.uint8)
  status = native.library().xmc_resize_bilinear(
      image.ctypes.data, in_h, in_w, channels, out.ctypes.data, height, width)
  if status != 0:
    raise ValueError(f"cannot resize {image.shape} to {(height, width)}")
  return out

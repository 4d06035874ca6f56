"""Image grids and PNG files (the JAX package's ``utils/image_utils.py``).

The PNG encoder is written here with ``zlib`` (8-bit RGB or grey, no
filter), so that writing samples needs no imaging package.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional

import numpy as np

from xmcgan_image_generation_tpu_torch.utils import fileio


def make_grid(images: np.ndarray, max_images: int = 64) -> np.ndarray:
  """Tiles ``[N, H, W, C]`` into one ``[rows*H, cols*W, C]`` image, the
  first ``min(N, max_images)`` images in the most square grid that
  fits."""
  images = np.asarray(images, np.float32)
  n = min(images.shape[0], max_images)
  images = images[:n]
  cols = int(math.ceil(math.sqrt(n)))
  rows = int(math.ceil(n / cols))
  _, h, w, c = images.shape
  pad = rows * cols - n
  if pad:
    images = np.concatenate(
        [images, np.zeros((pad, h, w, c), images.dtype)], axis=0)
  grid = images.reshape(rows, cols, h, w, c)
  return grid.transpose(0, 2, 1, 3, 4).reshape(rows * h, cols * w, c)


def encode_png(arr: np.ndarray) -> bytes:
  """A ``uint8`` ``[H, W]`` or ``[H, W, 3]`` array as PNG bytes."""
  if arr.ndim == 2:
    arr = arr[..., None]
  h, w, c = arr.shape
  color_type = {1: 0, 3: 2}[c]
  rows = np.concatenate([np.zeros((h, 1), np.uint8),
                         np.ascontiguousarray(arr).reshape(h, w * c)], 1)

  def chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

  header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
  return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
          + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
          + chunk(b"IEND", b""))


def save_image(images: np.ndarray, path: str,
               max_images: Optional[int] = 64) -> None:
  """Writes a [0, 1] float image (or a batch, as a grid) to a PNG file."""
  images = np.asarray(images, np.float32)
  if images.ndim == 4:
    images = make_grid(images, max_images or images.shape[0])
  arr = np.clip(images * 255.0 + 0.5, 0, 255).astype(np.uint8)
  if arr.shape[-1] == 1:
    arr = arr[..., 0]
  fileio.atomic_write(path, encode_png(arr))

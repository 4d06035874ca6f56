"""PNG decoding without an imaging package, as ``Image.open(...).convert(
"RGB")`` of Pillow gives it.

The machine that drives the card has no imaging package.  `decode` parses
the chunks, joins the IDAT chunks, inflates them with ``zlib`` and undoes
the rows' filters in the host helper (``csrc/host/fastio.cpp``), then
converts to RGB as Pillow does: RGBA drops its alpha, gray is copied into
the three channels.  It reads 8-bit RGB (color type 2), RGBA (6) and gray
(0), not interlaced, and raises on anything else; the records that
``tools/preprocess_coco.py`` of the JAX package writes are 8-bit RGB.
`unfilter_plain` is the un-filter in numpy, against which the tests hold
the helper.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

from xmcgan_image_generation_tpu_torch.data import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}    # color type -> samples per pixel


def _chunks(data: bytes, name: str) -> Tuple[Tuple[int, ...], bytes]:
  """The IHDR fields (width, height, bit depth, color type, compression,
  filter method, interlace) and the joined IDAT payload."""
  if data[:8] != SIGNATURE:
    raise ValueError(f"{name}: not a PNG")
  pos, header, idat = 8, None, []
  while pos + 8 <= len(data):
    length, kind = struct.unpack(">I4s", data[pos:pos + 8])
    body = data[pos + 8:pos + 8 + length]
    pos += 12 + length
    if kind == b"IHDR":
      header = struct.unpack(">IIBBBBB", body)
    elif kind == b"IDAT":
      idat.append(body)
    elif kind == b"IEND":
      break
  if header is None or not idat:
    raise ValueError(f"{name}: PNG without IHDR or IDAT")
  return header, b"".join(idat)


def _layout(data: bytes, name: str) -> Tuple[bytes, int, int, int]:
  """The inflated rows, height, width and samples per pixel."""
  (width, height, depth, color, _, _, interlace), payload = _chunks(data,
                                                                    name)
  if depth != 8 or color not in CHANNELS or interlace != 0:
    raise ValueError(
        f"{name}: unsupported PNG (bit depth {depth}, color type {color}, "
        f"interlace {interlace}); only non-interlaced 8-bit RGB, RGBA and "
        f"gray are read")
  return zlib.decompress(payload), height, width, CHANNELS[color]


def _to_rgb(pixels: np.ndarray) -> np.ndarray:
  if pixels.shape[2] == 3:
    return pixels
  if pixels.shape[2] == 4:
    return np.ascontiguousarray(pixels[:, :, :3])
  return np.repeat(pixels, 3, axis=2)


def unfilter_plain(raw: bytes, height: int, row_bytes: int,
                   bpp: int) -> np.ndarray:
  """numpy version of the helper's un-filter: ``height`` rows of a
  filter-type byte and ``row_bytes`` filtered bytes -> [height,
  row_bytes] uint8."""
  if len(raw) != height * (row_bytes + 1):
    raise ValueError(f"{len(raw)} bytes for {height} rows of {row_bytes}")
  rows = np.frombuffer(raw, np.uint8).reshape(height, row_bytes + 1)
  out = np.zeros((height, row_bytes), np.uint8)
  prior = np.zeros(row_bytes, np.uint8)
  for y in range(height):
    kind, line = int(rows[y, 0]), rows[y, 1:]
    if kind == 0:
      out[y] = line
    elif kind == 1:
      out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    elif kind == 2:
      out[y] = line + prior
    elif kind in (3, 4):
      out[y] = _sequential(kind, line.tolist(), prior.tolist(), bpp)
    else:
      raise ValueError(f"unknown PNG filter type {kind} in row {y}")
    prior = out[y]
  return out


def _sequential(kind: int, line: List[int], prior: List[int],
                bpp: int) -> List[int]:
  """Average (3) and Paeth (4): each byte needs the one just rebuilt."""
  row = [0] * len(line)
  for x, value in enumerate(line):
    a = row[x - bpp] if x >= bpp else 0
    b = prior[x]
    if kind == 3:
      row[x] = (value + ((a + b) >> 1)) & 0xFF
    else:
      c = prior[x - bpp] if x >= bpp else 0
      p = a + b - c
      pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
      pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
      row[x] = (value + pred) & 0xFF
  return row


def unfilter(raw: bytes, height: int, row_bytes: int, bpp: int
             ) -> np.ndarray:
  """The un-filtered rows, [height, row_bytes] uint8 (host helper)."""
  out = np.empty((height, row_bytes), np.uint8)
  status = native.library().xmc_png_unfilter(raw, len(raw), height,
                                              row_bytes, bpp, out.ctypes.data)
  if status == -1:
    raise ValueError(f"{len(raw)} bytes for {height} rows of {row_bytes}")
  if status != 0:
    raise ValueError("unknown PNG filter type")
  return out


def decode(data: bytes, name: str = "PNG", plain: bool = False
           ) -> np.ndarray:
  """PNG bytes -> uint8 RGB [H, W, 3]; ``name`` (the record) goes into the
  errors.  ``plain`` takes `unfilter_plain` in place of the helper."""
  raw, height, width, bpp = _layout(data, name)
  rows = (unfilter_plain if plain else unfilter)(raw, height, width * bpp,
                                                 bpp)
  return _to_rgb(rows.reshape(height, width, bpp))

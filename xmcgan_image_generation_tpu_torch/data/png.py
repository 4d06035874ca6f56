"""PNG decoding without an imaging package, as ``Image.open(...).convert(
"RGB")`` of Pillow gives it, and encoding.

The machine that drives the card has no imaging package.  `decode` parses
the chunks, joins the IDAT chunks, inflates them with ``zlib`` and undoes
the rows' filters in the host helper (``csrc/host/fastio.cpp``), then
converts to RGB as Pillow does: RGBA drops its alpha, gray is copied into
the three channels.  It reads 8-bit RGB (color type 2), RGBA (6) and gray
(0), not interlaced, and raises on anything else; the records that
``tools/preprocess_coco.py`` of the JAX package writes are 8-bit RGB.
`unfilter_plain` is the un-filter in numpy, against which the tests hold
the helper.

`encode` writes an 8-bit PNG with ``zlib``: each row takes the filter type
whose bytes, read as signed, have the least sum of magnitudes (libpng's
heuristic), or the types a caller names in turn.  Its bytes need not
equal Pillow's; the pixels decoded back do.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from xmcgan_image_generation_tpu_torch.data import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}    # color type -> samples per pixel
COLOR_TYPE = {c: t for t, c in CHANNELS.items()}


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


def _chunk(kind: bytes, body: bytes) -> bytes:
  return (struct.pack(">I", len(body)) + kind + body
          + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def filtered_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
  """``rows`` [height, row_bytes] uint8 under each filter type 0-4:
  [5, height, row_bytes] uint8 (each predicted from the raw bytes)."""
  x = rows.astype(np.int16)
  up = np.zeros_like(x)
  up[1:] = x[:-1]
  left = np.zeros_like(x)
  left[:, bpp:] = x[:, :-bpp]
  upleft = np.zeros_like(x)
  upleft[1:, bpp:] = x[:-1, :-bpp]
  p = left + up - upleft
  pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
  paeth = np.where((pa <= pb) & (pa <= pc), left,
                   np.where(pb <= pc, up, upleft))
  preds = (0, left, up, (left + up) >> 1, paeth)
  return np.stack([(x - pred) & 255 for pred in preds]).astype(np.uint8)


def encode(image: np.ndarray, filters: Optional[Sequence[int]] = None
           ) -> bytes:
  """uint8 [H, W, 3] (RGB), [H, W, 4] (RGBA) or [H, W] (gray) -> PNG bytes,
  deflated at zlib's level 6 (Pillow's default).  ``filters``: the filter
  types that the rows take in turn (default: each row the type of least
  sum of signed magnitudes)."""
  image = np.asarray(image)
  if image.dtype != np.uint8:
    raise ValueError(f"PNG encode: dtype {image.dtype}, expected uint8")
  if image.ndim == 2:
    image = image[:, :, None]
  h, w, ch = image.shape
  if ch not in COLOR_TYPE:
    raise ValueError(f"PNG encode: {ch} channels; 1, 3 or 4 are written")
  candidates = filtered_rows(image.reshape(h, w * ch), ch)
  if filters is None:
    cost = np.abs(candidates.view(np.int8).astype(np.int32)).sum(axis=2)
    kinds = np.argmin(cost, axis=0)
  else:
    kinds = np.resize(np.asarray(filters, np.int64), h)
  body = np.concatenate([kinds.astype(np.uint8)[:, None],
                         candidates[kinds, np.arange(h)]], axis=1)
  header = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPE[ch], 0, 0, 0)
  return (SIGNATURE + _chunk(b"IHDR", header)
          + _chunk(b"IDAT", zlib.compress(body.tobytes(), 6))
          + _chunk(b"IEND", b""))

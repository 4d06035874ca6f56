"""TensorBoard event files, written by hand (the JAX package's
``utils/tb_writer.py``).

The reference writes its training curves through a TensorBoard backend,
so users point TensorBoard at the workdir.  The ``Event`` and ``Summary``
protos are small and stable; they are encoded here on the TFRecord
framing of `data.records`, with no TensorFlow.

Wire format:
  * record framing: ``{uint64 len, masked-crc32c(len), bytes,
    masked-crc32c}`` (`data.records.TFRecordWriter`);
  * ``Event``: wall_time=1 (double), step=2 (int64), file_version=3
    (string), summary=5 (message);
  * ``Summary``: repeated Value=1; ``Summary.Value``: tag=1 (string),
    simple_value=2 (float), image=4 (message);
  * ``Summary.Image``: height=1, width=2, colorspace=3, encoded=4 (bytes).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Mapping, Optional

import numpy as np

from xmcgan_image_generation_tpu_torch.data import records
from xmcgan_image_generation_tpu_torch.utils import fileio
from xmcgan_image_generation_tpu_torch.utils import image_utils


def _varint_field(field: int, value: int) -> bytes:
  return records._tag(field, 0) + records._write_varint(int(value))


def _double_field(field: int, value: float) -> bytes:
  return records._tag(field, 1) + struct.pack("<d", float(value))


def _float_field(field: int, value: float) -> bytes:
  return records._tag(field, 5) + struct.pack("<f", float(value))


def _bytes_field(field: int, payload: bytes) -> bytes:
  return records._length_delimited(field, payload)


def _event(step: int, summary: bytes,
           wall_time: Optional[float] = None) -> bytes:
  return (_double_field(1, time.time() if wall_time is None else wall_time)
          + _varint_field(2, step) + _bytes_field(5, summary))


def scalar_summary(scalars: Mapping[str, float]) -> bytes:
  out = b""
  for tag, value in scalars.items():
    out += _bytes_field(1, _bytes_field(1, tag.encode("utf-8"))
                        + _float_field(2, value))
  return out


def image_summary(tag: str, png: bytes, height: int, width: int,
                  colorspace: int = 3) -> bytes:
  image = (_varint_field(1, height) + _varint_field(2, width)
           + _varint_field(3, colorspace) + _bytes_field(4, png))
  return _bytes_field(1, _bytes_field(1, tag.encode("utf-8"))
                      + _bytes_field(4, image))


def encode_png(image: np.ndarray) -> bytes:
  """``[H, W, C]`` float image in [0, 1] -> PNG bytes (the port's own
  encoder: the pixels of the JAX package's, not its compressed bytes)."""
  arr = np.clip(np.asarray(image, np.float32) * 255.0 + 0.5,
                0, 255).astype(np.uint8)
  if arr.ndim == 3 and arr.shape[-1] == 1:
    arr = arr[..., 0]
  return image_utils.encode_png(arr)


class EventFileWriter:
  """Appends ``Event`` records to one ``events.out.tfevents.*`` file."""

  def __init__(self, logdir: str):
    fileio.makedirs(logdir)
    name = (f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}")
    self.path = fileio.join(logdir, name)
    self._w = records.TFRecordWriter(self.path)
    # TensorBoard skips a file whose first record is not this stamp.
    self._w.write(_double_field(1, time.time())
                  + _bytes_field(3, b"brain.Event:2"))
    self.flush()

  def write_scalars(self, step: int, scalars: Mapping[str, float]) -> None:
    self._w.write(_event(step, scalar_summary(scalars)))

  def write_image(self, step: int, tag: str, image: np.ndarray) -> None:
    """``image``: ``[H, W, C]`` float array in [0, 1]."""
    png = encode_png(image)
    self._w.write(_event(
        step, image_summary(tag, png, image.shape[0], image.shape[1],
                            colorspace=image.shape[-1])))

  def flush(self) -> None:
    self._w.flush()

  def close(self) -> None:
    self._w.close()

"""TFRecord files of ``tf.train.Example`` protos, without TensorFlow (the
JAX package's ``data/records.py``).

* TFRecord framing: ``{uint64 length, uint32 masked-crc(length),
  bytes data[length], uint32 masked-crc(data)}`` per record.
* A minimal protobuf wire-format codec for the ``Example`` message tree
  (Features -> map<string, Feature> -> BytesList/FloatList/Int64List).

`TFRecordFile` reads records at random through an offset index, built on
first open and kept beside the file as ``<file>.idx`` (int64 offsets, the
JAX package's format) when the directory is writable; it reads with
``pread`` on one file handle, so threads share it.  CRC32C and the offset
scan run in the host helper (``csrc/host/fastio.cpp``); `crc32c_plain`
and `scan_offsets_plain` are the same in Python, for the tests.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, Iterator, List, Tuple, Union

import numpy as np

from xmcgan_image_generation_tpu_torch.data import native
from xmcgan_image_generation_tpu_torch.utils import fileio

Feature = Union[List[bytes], np.ndarray]

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) with the TFRecord masking.
# ---------------------------------------------------------------------------


def _crc_table() -> List[int]:
  table = []
  for i in range(256):
    crc = i
    for _ in range(8):
      crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    table.append(crc)
  return table


def crc32c_plain(data: bytes) -> int:
  """Table-driven CRC32C in Python."""
  table = _crc_table()
  crc = 0xFFFFFFFF
  for b in data:
    crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
  return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
  """CRC32C checksum (host helper, slicing-by-8)."""
  return int(native.library().xmc_crc32c(data, len(data)))


def masked_crc(data: bytes) -> int:
  crc = crc32c(data)
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire-format primitives.
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
  result = 0
  shift = 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7


def _write_varint(value: int) -> bytes:
  out = bytearray()
  while True:
    bits = value & 0x7F
    value >>= 7
    if value:
      out.append(bits | 0x80)
    else:
      out.append(bits)
      return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
  return _write_varint((field << 3) | wire_type)


def _length_delimited(field: int, payload: bytes) -> bytes:
  return _tag(field, 2) + _write_varint(len(payload)) + payload


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes, int]]:
  """Yields (field_number, wire_type, value_bytes_or_int, end_pos)."""
  pos = 0
  n = len(buf)
  while pos < n:
    key, pos = _read_varint(buf, pos)
    field, wire_type = key >> 3, key & 7
    if wire_type == 0:  # varint
      value, pos = _read_varint(buf, pos)
      yield field, wire_type, value, pos
    elif wire_type == 2:  # length-delimited
      size, pos = _read_varint(buf, pos)
      yield field, wire_type, buf[pos:pos + size], pos + size
      pos += size
    elif wire_type == 5:  # 32-bit
      yield field, wire_type, buf[pos:pos + 4], pos + 4
      pos += 4
    elif wire_type == 1:  # 64-bit
      yield field, wire_type, buf[pos:pos + 8], pos + 8
      pos += 8
    else:
      raise ValueError(f"Unsupported wire type {wire_type}")


# ---------------------------------------------------------------------------
# tf.train.Example encode / decode.
# ---------------------------------------------------------------------------


def _decode_feature(buf: bytes) -> Feature:
  """Decodes a `Feature` message into list[bytes] or a numpy array."""
  for field, _, value, _ in _iter_fields(buf):
    if field == 1:  # BytesList
      return [v for f, _, v, _ in _iter_fields(value) if f == 1]
    if field == 2:  # FloatList, packed or one value per field
      floats = [np.frombuffer(v, dtype="<f4")
                for f, w, v, _ in _iter_fields(value)
                if f == 1 and w in (2, 5)]
      return (np.concatenate(floats) if floats
              else np.zeros((0,), np.float32))
    if field == 3:  # Int64List
      ints: List[int] = []
      for f, w, v, _ in _iter_fields(value):
        if f != 1:
          continue
        if w == 2:  # packed varints
          pos = 0
          while pos < len(v):
            x, pos = _read_varint(v, pos)
            ints.append(x)
        elif w == 0:
          ints.append(v)
      # Signed int64: the two's complement of the varint's value.
      return np.array(ints, dtype=np.uint64).astype(np.int64)
  return []


def parse_example(serialized: bytes) -> Dict[str, Feature]:
  """Parses a serialized `tf.train.Example` into a feature dict."""
  features: Dict[str, Feature] = {}
  for field, _, value, _ in _iter_fields(serialized):
    if field != 1:  # Example.features
      continue
    for f2, _, entry, _ in _iter_fields(value):
      if f2 != 1:  # Features.feature map entry
        continue
      key = None
      feat = None
      for f3, _, v3, _ in _iter_fields(entry):
        if f3 == 1:
          key = v3.decode("utf-8")
        elif f3 == 2:
          feat = _decode_feature(v3)
      if key is not None:
        features[key] = feat if feat is not None else []
  return features


def _encode_feature(value) -> bytes:
  """Encodes bytes/str lists, float arrays, or int arrays as a Feature."""
  if isinstance(value, (bytes, str)):
    value = [value]
  if isinstance(value, (list, tuple)) and value and isinstance(
      value[0], (bytes, str)):
    payload = b"".join(
        _length_delimited(1, v.encode("utf-8") if isinstance(v, str) else v)
        for v in value)
    return _length_delimited(1, payload)  # BytesList
  arr = np.asarray(value)
  if arr.dtype.kind == "f":
    data = arr.astype("<f4").ravel().tobytes()
    payload = _tag(1, 2) + _write_varint(len(data)) + data  # packed floats
    return _length_delimited(2, payload)  # FloatList
  if arr.dtype.kind in ("i", "u"):
    packed = b"".join(
        _write_varint(int(np.uint64(np.int64(x)))) for x in arr.ravel())
    payload = _tag(1, 2) + _write_varint(len(packed)) + packed
    return _length_delimited(3, payload)  # Int64List
  raise TypeError(f"Unsupported feature type: {arr.dtype}")


def build_example(features: Dict[str, Feature]) -> bytes:
  """Serializes a feature dict as a `tf.train.Example`."""
  entries = []
  for key, value in features.items():
    entry = (_length_delimited(1, key.encode("utf-8"))
             + _length_delimited(2, _encode_feature(value)))
    entries.append(_length_delimited(1, entry))
  return _length_delimited(1, b"".join(entries))


# ---------------------------------------------------------------------------
# TFRecord file reader / writer.
# ---------------------------------------------------------------------------

_CRC_STRUCT = struct.Struct("<I")


class TFRecordWriter:
  """Writes TFRecord files readable by TF and by `TFRecordFile`."""

  def __init__(self, path: str):
    # Through the seam: TensorBoard events go into a remote workdir
    # (`utils.tb_writer`), and appear there when the file is closed.
    self._f = fileio.open(path, "wb")

  def write(self, record: bytes) -> None:
    header = struct.pack("<Q", len(record))
    self._f.write(header)
    self._f.write(_CRC_STRUCT.pack(masked_crc(header)))
    self._f.write(record)
    self._f.write(_CRC_STRUCT.pack(masked_crc(record)))

  def flush(self) -> None:
    self._f.flush()

  def close(self) -> None:
    self._f.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


def scan_offsets_plain(path: str) -> np.ndarray:
  """The start offset of every complete record, in Python: hops over the
  length headers and leaves out a truncated last record."""
  offsets = []
  size = os.path.getsize(path)
  with open(path, "rb") as f:
    pos = 0
    while pos < size:
      f.seek(pos)
      header = f.read(8)
      if len(header) < 8:
        break
      (length,) = struct.unpack("<Q", header)
      end = pos + 8 + 4 + length + 4
      if end > size:
        break
      offsets.append(pos)
      pos = end
  return np.asarray(offsets, np.int64)


def scan_offsets(path: str) -> np.ndarray:
  """`scan_offsets_plain` in the host helper."""
  lib = native.library()
  # A record takes at least 16 bytes of framing.
  capacity = os.path.getsize(path) // 16 + 1
  buf = np.empty(capacity, np.int64)
  n = lib.xmc_scan_offsets(os.fsencode(path), buf.ctypes.data, capacity)
  if n < 0:
    raise OSError(f"scanning the records of {path} failed ({n})")
  return buf[:n].copy()


class TFRecordFile:
  """Random-access view of one TFRecord file.

  The offset index is built on first open and cached as ``<path>.idx``
  when the directory is writable, so later opens read it.
  """

  def __init__(self, path: str, verify_crc: bool = False):
    self.path = path
    self.verify_crc = verify_crc
    idx_path = path + ".idx"
    if os.path.exists(idx_path) and (
        os.path.getmtime(idx_path) >= os.path.getmtime(path)):
      self.offsets = np.fromfile(idx_path, np.int64)
    else:
      self.offsets = scan_offsets(path)
      try:
        self.offsets.tofile(idx_path)
      except OSError:
        pass  # Read-only directory: keep the index in memory.
    self._file = None
    self._open_lock = threading.Lock()

  def __len__(self) -> int:
    return len(self.offsets)

  def read(self, index: int) -> bytes:
    f = self._file
    if f is None:  # Opened lazily, once per process.
      with self._open_lock:
        if self._file is None:
          self._file = open(self.path, "rb")
        f = self._file
    fd = f.fileno()
    offset = int(self.offsets[index])
    (length,) = struct.unpack("<Q", os.pread(fd, 8, offset))
    frame = os.pread(fd, 4 + length + 4, offset + 8)
    data = frame[4:4 + length]
    if self.verify_crc:
      (crc,) = _CRC_STRUCT.unpack(frame[4 + length:])
      if crc != masked_crc(data):
        raise IOError(f"CRC mismatch in {self.path} record {index}")
    return data

  def __getstate__(self):
    state = self.__dict__.copy()
    state["_file"] = None
    del state["_open_lock"]
    return state

  def __setstate__(self, state):
    self.__dict__.update(state)
    self._open_lock = threading.Lock()

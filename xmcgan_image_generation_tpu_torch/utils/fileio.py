"""Local-path file helpers (the part of the JAX package's
``utils/fileio.py`` that the port's checkpoints, services and writers
call; no remote filesystems)."""

from __future__ import annotations

import os
import tempfile
from typing import List

join = os.path.join
dirname = os.path.dirname
exists = os.path.exists
isdir = os.path.isdir


def abspath(path: str) -> str:
  return os.path.abspath(os.path.expanduser(path))


def makedirs(path: str, exist_ok: bool = True) -> None:
  os.makedirs(path, exist_ok=exist_ok)


def listdir(path: str) -> List[str]:
  return sorted(os.listdir(path))


def atomic_write(path: str, data) -> None:
  """Writes ``data`` (str or bytes) to a temporary file beside ``path``
  and renames it over ``path``: readers see the old file or the new one,
  never a part."""
  directory = dirname(abspath(path))
  makedirs(directory)
  mode = "wb" if isinstance(data, bytes) else "w"
  fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-")
  try:
    with os.fdopen(fd, mode) as f:
      f.write(data)
    os.replace(tmp, path)
  except BaseException:
    if exists(tmp):
      os.remove(tmp)
    raise


def append_text(path: str, text: str) -> None:
  with open(path, "a") as f:
    f.write(text)

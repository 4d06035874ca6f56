"""Local-path file helpers (the part of the JAX package's
``utils/fileio.py`` that the port's checkpoints, services, writers and
preemption guard call; no remote filesystems)."""

from __future__ import annotations

import os
import tempfile
import threading
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


def read_text(path: str) -> str:
  with open(path, "r") as f:
    return f.read()


def remove(path: str) -> None:
  os.remove(path)


def create_exclusive(path: str, data) -> bool:
  """Creates ``path`` holding ``data`` if it does not exist, atomically:
  True when this caller created it, False when it existed.  The content
  is written to a temporary file first and linked to ``path`` (the link
  fails if ``path`` exists), so a reader never sees a part of it."""
  if isinstance(data, str):
    data = data.encode("utf-8")
  # Unique per process and thread: racing threads share the pid.
  tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
  try:
    os.remove(tmp)  # left by a crashed attempt of this process and thread
  except OSError:
    pass
  fd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
  try:
    with os.fdopen(fd, "wb") as f:
      f.write(data)
    try:
      os.link(tmp, path)
    except FileExistsError:
      return False
    return True
  finally:
    try:
      os.remove(tmp)
    except OSError:
      pass

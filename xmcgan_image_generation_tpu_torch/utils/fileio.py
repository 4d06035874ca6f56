"""The workdir's filesystem seam: a plain ``os`` path for local paths and
fsspec for ``scheme://`` paths (the JAX package's ``utils/fileio.py``).

Every service that reads or writes a training workdir goes through this
module: checkpoints and their discovery, ``scores.csv``, ``TRAIN_DONE``,
the preemption marker, ``metrics.jsonl``, TensorBoard events, image grids
and serving artifacts.  So ``--workdir=gs://bucket/run`` puts all of them
on object storage, shared by every process of a job, and
``--workdir=memory://run`` keeps them in the process's memory (tests).

Rules:

* A path without a scheme takes ``os`` and the builtin ``open``; fsspec is
  imported only for a ``scheme://`` path, in `_fs`.
* A ``scheme://`` path resolves to fsspec's filesystem for the scheme,
  one a scheme and process.  A scheme whose backend is not installed
  (``gs`` without gcsfs) raises fsspec's error naming it: nothing falls
  back to a local directory.
* Paths go in and come out whole (scheme kept), so callers treat them as
  opaque strings.
* Object-store semantics are stated, not emulated:
  - `atomic_write` is a temporary file and ``os.replace`` locally and one
    PUT on a store (an object is visible only once it is whole);
  - `create_exclusive` (create if absent, the preemption marker's first
    writer wins) is ``O_EXCL`` and ``os.link`` locally and an
    ``ifGenerationMatch=0`` PUT on GCS (``pipe_file(mode="create")``);
  - `append_text`: a store cannot append, so a remote append reads,
    appends and writes the whole (small) object;
  - `rename` on a store is copy and delete, which is not atomic.
"""

from __future__ import annotations

import builtins
import glob as _glob
import io
import logging
import os
import posixpath
import shutil
import tempfile
import threading
from typing import IO, List, Optional, Tuple

log = logging.getLogger("xmcgan_torch")

_SEP = "://"

# Serializes the read-modify-write operations of one process on a store
# (memory:// has no server to arbitrate them; GCS arbitrates its own).
_LOCAL_LOCK = threading.Lock()


def split_scheme(path: str) -> Tuple[Optional[str], str]:
  """``"gs://b/k" -> ("gs", "b/k")``; a plain path -> ``(None, path)``."""
  if _SEP in path:
    scheme, rest = path.split(_SEP, 1)
    if scheme and scheme.isalnum() and len(scheme) > 1:
      return scheme, rest
  return None, path


def is_remote(path: str) -> bool:
  return split_scheme(path)[0] is not None


_FS_CACHE = {}


def _fs(path: str):
  """fsspec's filesystem for ``path``'s scheme (one a process).

  Listing caches are off: with gcsfs's default ``cache_timeout=None`` a
  listing never expires, so a poller (the evaluation service waiting for
  a checkpoint, or for ``TRAIN_DONE``) would read its first listing for
  ever and miss every checkpoint written after it.  The seam lists small
  bookkeeping directories at human intervals, so a fresh listing costs
  nothing, and a stale one is a liveness fault.
  """
  scheme = split_scheme(path)[0]
  if scheme is None:
    raise ValueError(f"{path!r} is a local path")
  fs = _FS_CACHE.get(scheme)
  if fs is None:
    import fsspec

    fs = fsspec.filesystem(scheme, use_listings_cache=False)
    _FS_CACHE[scheme] = fs
  return fs


def _with_scheme(scheme: str, stripped: str) -> str:
  return f"{scheme}{_SEP}{stripped.lstrip('/') if scheme == 'memory' else stripped}"


# -- paths -------------------------------------------------------------------


def join(base: str, *parts: str) -> str:
  if is_remote(base):
    return posixpath.join(base, *parts)
  return os.path.join(base, *parts)


def dirname(path: str) -> str:
  if is_remote(path):
    return posixpath.dirname(path)
  return os.path.dirname(path)


def basename(path: str) -> str:
  if is_remote(path):
    return posixpath.basename(path.rstrip("/"))
  return os.path.basename(path)


def abspath(path: str) -> str:
  """``os.path.abspath`` (after ``~``) of a local path; a remote urlpath
  is absolute as it is."""
  if is_remote(path):
    return path
  return os.path.abspath(os.path.expanduser(path))


# -- predicates and listings -------------------------------------------------


def exists(path: str) -> bool:
  if not is_remote(path):
    return os.path.exists(path)
  return _fs(path).exists(path)


def isdir(path: str) -> bool:
  if not is_remote(path):
    return os.path.isdir(path)
  return _fs(path).isdir(path)


def listdir(path: str) -> List[str]:
  """The names in ``path`` (as ``os.listdir``, directory markers left
  out), sorted."""
  if not is_remote(path):
    return sorted(os.listdir(path))
  out = []
  for child in _fs(path).ls(path, detail=False):
    name = posixpath.basename(child.rstrip("/"))
    if name:
      out.append(name)
  return sorted(out)


def glob(pattern: str) -> List[str]:
  """The paths matching ``pattern``, whole (scheme kept), sorted."""
  if not is_remote(pattern):
    return sorted(_glob.glob(pattern))
  scheme = split_scheme(pattern)[0]
  return sorted(_with_scheme(scheme, p) for p in _fs(pattern).glob(pattern))


def getsize(path: str) -> int:
  """The size of the file at ``path`` in bytes."""
  if not is_remote(path):
    return os.path.getsize(path)
  return int(_fs(path).size(path))


# -- changes -----------------------------------------------------------------


def makedirs(path: str, exist_ok: bool = True) -> None:
  if not is_remote(path):
    os.makedirs(path, exist_ok=exist_ok)
    return
  # A store has no directories: gcsfs only checks the bucket; memory://
  # keeps pseudo-directories.
  try:
    _fs(path).makedirs(path, exist_ok=exist_ok)
  except FileExistsError:
    if not exist_ok:
      raise


def remove(path: str) -> None:
  if not is_remote(path):
    os.remove(path)
    return
  _fs(path).rm_file(path)


def rmtree(path: str) -> None:
  if not is_remote(path):
    shutil.rmtree(path)
    return
  _fs(path).rm(path, recursive=True)


def rename(src: str, dst: str) -> None:
  """Moves ``src`` over ``dst``.  Atomic locally; on a store a copy and a
  delete, which is not (use `atomic_write` to publish)."""
  if not is_remote(src):
    os.replace(src, dst)
    return
  fs = _fs(src)
  fs.copy(src, dst)
  fs.rm_file(src)


# -- files -------------------------------------------------------------------


def open(path: str, mode: str = "r", **kwargs) -> IO:  # noqa: A001
  """The builtin ``open`` for a local path, fsspec's for a remote one.

  A remote file being written is buffered and uploaded (in parts above
  the block size), and the object appears whole when the file is
  closed.  A remote ``"a"`` or ``"x"`` mode raises: use `append_text` or
  `create_exclusive`.
  """
  if not is_remote(path):
    return builtins.open(path, mode, **kwargs)
  if "a" in mode:
    raise ValueError(
        f"append mode not supported on object stores ({path!r}); "
        "use fileio.append_text")
  if "x" in mode:
    raise ValueError(
        f"exclusive-create open not supported remotely ({path!r}); "
        "use fileio.create_exclusive")
  return _fs(path).open(path, mode, **kwargs)


def discard(f: IO, path: str) -> None:
  """Throws away ``f``, a remote file that `open` gave for writing at
  ``path`` and that has not been closed: nothing written to it stays at
  ``path``.  gcsfs cancels its resumable upload; the file is then marked
  closed, since closing it (as garbage collection would) publishes what
  it holds.  memory://, which stores a file from its open, drops it.  A
  cancel that fails is logged: an upload never finalized publishes
  nothing."""
  try:
    f.discard()
  except Exception as e:  # pylint: disable=broad-except
    log.warning("Could not cancel the upload of %s: %r", path, e)
  if isinstance(f, io.BytesIO):      # memory://'s MemoryFile
    if _fs(path).exists(path):
      _fs(path).rm_file(path)
  else:
    f.closed = True


def read_bytes(path: str) -> bytes:
  with open(path, "rb") as f:
    return f.read()


def read_text(path: str) -> str:
  with open(path, "r") as f:
    return f.read()


def atomic_write(path: str, data) -> None:
  """Writes ``data`` (str or bytes) so that readers see the old content or
  all of the new, never a part: locally a temporary file beside ``path``
  renamed over it, on a store one PUT."""
  if is_remote(path):
    if isinstance(data, str):
      data = data.encode("utf-8")
    _fs(path).pipe_file(path, data)
    return
  directory = dirname(abspath(path))
  makedirs(directory)
  mode = "wb" if isinstance(data, bytes) else "w"
  fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-")
  try:
    with os.fdopen(fd, mode) as f:
      f.write(data)
    os.replace(tmp, path)
  except BaseException:
    if os.path.exists(tmp):
      os.remove(tmp)
    raise


def append_text(path: str, text: str) -> None:
  """Appends ``text`` to a small text file (CSV rows, JSON lines).  On a
  store: read, append and `atomic_write` the whole object, under this
  process's lock; for files of kilobytes, not bulk data."""
  if not is_remote(path):
    with builtins.open(path, "a") as f:
      f.write(text)
    return
  with _LOCAL_LOCK:
    try:
      existing = read_bytes(path)
    except FileNotFoundError:
      existing = b""
    _fs(path).pipe_file(path, existing + text.encode("utf-8"))


def create_exclusive(path: str, data) -> bool:
  """Creates ``path`` holding ``data`` if it does not exist, atomically:
  True when this caller created it, False when it existed.  Of N racing
  writers exactly one wins, and a reader never sees a part.

  Locally the content goes to a temporary file that is linked to
  ``path`` (the link fails if ``path`` exists).  On GCS it is
  ``pipe_file(mode="create")``, an ``ifGenerationMatch=0`` upload that
  the server arbitrates.  A backend without that mode gets a check and a
  write under this process's lock, logged: atomic for memory://, best
  effort elsewhere.
  """
  if isinstance(data, str):
    data = data.encode("utf-8")
  if not is_remote(path):
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
  fs = _fs(path)
  try:
    with _LOCAL_LOCK:
      fs.pipe_file(path, data, mode="create")
    return True
  except FileExistsError:
    return False
  except (ValueError, TypeError, NotImplementedError) as e:
    log.warning(
        "%s:// backend lacks atomic create-if-absent (%s); falling back "
        "to exists-check + write", split_scheme(path)[0], e)
    with _LOCAL_LOCK:
      if fs.exists(path):
        return False
      fs.pipe_file(path, data)
    return True


class AppendableFile:
  """A handle that appends (``metrics.jsonl``).

  Locally an ``"a"``-mode file.  Remotely the text is kept in memory (the
  object's content read once, at open) and each `flush` publishes the
  whole of it in one `atomic_write`: a metrics file grows by kilobytes a
  thousand steps, so the rewrite costs nothing beside a step.
  """

  def __init__(self, path: str):
    self.path = path
    if not is_remote(path):
      self._f = builtins.open(path, "a")
      self._buf = None
    else:
      self._f = None
      try:
        self._buf = [read_text(path)]
      except FileNotFoundError:
        self._buf = []
      self._dirty = False

  def write(self, text: str) -> None:
    if self._f is not None:
      self._f.write(text)
    else:
      self._buf.append(text)
      self._dirty = True

  def flush(self) -> None:
    if self._f is not None:
      self._f.flush()
    elif self._dirty:
      joined = "".join(self._buf)
      self._buf = [joined]
      atomic_write(self.path, joined)
      self._dirty = False

  def close(self) -> None:
    if self._f is not None:
      self._f.close()
    else:
      self.flush()

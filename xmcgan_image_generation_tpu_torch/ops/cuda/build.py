"""Builds the CUDA kernels of ``csrc/``, one shared library per source.

``nvcc`` compiles each ``.cu`` file of ``csrc/`` for ``sm_90a`` into a
library with a plain C interface; the compilers of all sources start
together and run in parallel.  `library` loads the libraries with
``ctypes`` and looks each entry point up in them.  The sources include no
PyTorch header, so a build takes seconds.  The libraries land in
``_build/`` beside the package, each named by a hash of its source (with
the headers of ``csrc/`` and the flags), so an edited kernel is rebuilt
and an unchanged one is not.  Nothing is built when this module is
imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every entry point in csrc/ (pointers and the stream as
# c_void_p, so that ctypes never cuts a 64-bit address).
SIGNATURES = {
    "xmc_ntxent_f32": (_P, _P, _P, _P, _I, _I, _F, _P),
    "xmc_ntxent_bf16": (_P, _P, _P, _P, _I, _I, _F, _P),
    "xmc_word_scores_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                            _F, _P),
    "xmc_word_scores_drn": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _F, _F, _P),
    "xmc_word_scores_dwn": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _F, _F, _P),
    "xmc_word_scores_group_size": (_I,),
    "xmc_word_scores_record_floats": (),
}


@dataclasses.dataclass
class BuildResult:
  paths: List[pathlib.Path]  # one library per source
  seconds: float     # wall time of the parallel build; 0.0 when all existed
  log: str           # nvcc's output, with -Xptxas -v's per-kernel lines


def _sources() -> List[pathlib.Path]:
  return sorted(CSRC_DIR.glob("*.cu"))


def source_hash(source: pathlib.Path) -> str:
  h = hashlib.sha256()
  for path in [source] + sorted(CSRC_DIR.glob("*.cuh")):
    h.update(path.name.encode())
    h.update(path.read_bytes())
  h.update(" ".join(NVCC_FLAGS).encode())
  return h.hexdigest()[:16]


def find_nvcc() -> str:
  """``nvcc`` from ``PATH``, else under the CUDA home PyTorch resolves."""
  nvcc = shutil.which("nvcc")
  if nvcc:
    return nvcc
  from torch.utils import cpp_extension

  home = os.environ.get("CUDA_HOME") or cpp_extension.CUDA_HOME
  if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
    return os.path.join(home, "bin", "nvcc")
  raise RuntimeError(
      "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
      "xmcgan_image_generation_tpu_torch cannot be built")


def build() -> BuildResult:
  """Compiles every ``csrc/*.cu`` whose library does not exist yet, one
  ``nvcc`` per source, all at once."""
  targets = {src: BUILD_DIR / f"lib{src.stem}_{source_hash(src)}.so"
             for src in _sources()}
  todo = [src for src, path in targets.items() if not path.exists()]
  if not todo:
    return BuildResult(list(targets.values()), 0.0, "")
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  start = time.perf_counter()
  logs, failed = [], []
  with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
    nvcc = find_nvcc()
    procs = {}
    for src in todo:
      out = os.path.join(tmp, targets[src].name)
      cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", out, str(src)]
      procs[src] = (cmd, out, subprocess.Popen(
          cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for src, (cmd, out, proc) in procs.items():
      log = proc.communicate()[0]
      logs.append(f"{src.name}:\n{log}")
      if proc.returncode != 0:
        failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                      f"{log}")
      else:
        # Atomic: a concurrent build of the same source writes the same
        # file.
        os.replace(out, targets[src])
  if failed:
    raise RuntimeError("\n".join(failed))
  return BuildResult(list(targets.values()), time.perf_counter() - start,
                     "\n".join(logs))


class _Library:
  """The entry points of ``SIGNATURES``, each from the library that
  exports it."""

  def __init__(self, paths: List[pathlib.Path]):
    libs = [ctypes.CDLL(str(p)) for p in paths]
    self._fns: Dict[str, object] = {}
    for name, argtypes in SIGNATURES.items():
      for lib in libs:
        try:
          fn = getattr(lib, name)
        except AttributeError:
          continue
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        self._fns[name] = fn
        break
      else:
        raise RuntimeError(f"no kernel library exports {name}")

  def __getattr__(self, name: str):
    try:
      return self._fns[name]
    except KeyError as e:
      raise AttributeError(name) from e


@functools.lru_cache(maxsize=None)
def library() -> _Library:
  """The kernels' libraries, built on first use and loaded once."""
  return _Library(build().paths)


def check(status: int, what: str) -> None:
  """Raises if a launch returned a CUDA error."""
  if status != 0:
    raise RuntimeError(f"{what}: CUDA error {status} at launch")

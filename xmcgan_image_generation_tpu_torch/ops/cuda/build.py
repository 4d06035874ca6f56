"""Builds the CUDA kernels of ``csrc/`` into one shared library.

``nvcc`` compiles every ``.cu`` file of ``csrc/`` for ``sm_90a`` into a
library with a plain C interface, which `library` loads with ``ctypes``.
The sources include no PyTorch header, so a build takes seconds.  The
library lands in ``_build/`` beside the package, named by a hash of the
sources, so an edited kernel is rebuilt and an unchanged one is not.
Nothing is built when this module is imported.
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
    "xmc_word_scores_group_size": (_I,),
    "xmc_word_scores_record_floats": (),
}


@dataclasses.dataclass
class BuildResult:
  path: pathlib.Path
  seconds: float     # 0.0 when the library was already built
  log: str           # nvcc's output, with -Xptxas -v's per-kernel lines


def _sources():
  return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
  h = hashlib.sha256()
  for path in _sources():
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
  """Compiles ``csrc/*.cu`` unless the library of these sources exists."""
  path = BUILD_DIR / f"libxmcgan_kernels_{source_hash()}.so"
  if path.exists():
    return BuildResult(path, 0.0, "")
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  cu_files = [str(p) for p in sorted(CSRC_DIR.glob("*.cu"))]
  start = time.perf_counter()
  with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
    out = os.path.join(tmp, path.name)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", out,
           *cu_files]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
      raise RuntimeError(
          f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    # Atomic: a concurrent build of the same sources writes the same file.
    os.replace(out, path)
  return BuildResult(path, time.perf_counter() - start, log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
  """The kernels' library, built on first use and loaded once."""
  lib = ctypes.CDLL(str(build().path))
  for name, argtypes in SIGNATURES.items():
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
  return lib


def check(status: int, what: str) -> None:
  """Raises if a launch returned a CUDA error."""
  if status != 0:
    raise RuntimeError(f"{what}: CUDA error {status} at launch")

"""Builds and binds the data loader's host helper, ``csrc/host/fastio.cpp``.

The helper holds the byte loops of the loader that numpy cannot vectorize:
CRC32C and the record-offset scan of TFRecord files, the PNG row
un-filter and Pillow's bilinear resampler.  The host C++ compiler builds
it on first use into ``_build/`` beside the package, named by a hash of
the source, the flags and the compiler's version, so an edited source is
rebuilt.  A build is written to a temporary name and renamed into place,
so processes that build at once do not see each other's partial files.
A failed build or load raises: the loader has no fallback.  Nothing is
built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "host" / "fastio.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64
_U32 = ctypes.c_uint32
# name -> (return type, argument types) of every entry point of SOURCE.
SIGNATURES = {
    "xmc_crc32c": (_U32, (_P, _U64)),
    "xmc_scan_offsets": (_I64, (_P, _P, _I64)),
    "xmc_png_unfilter": (_I, (_P, _I64, _I, _I, _I, _P)),
    "xmc_resize_bilinear": (_I, (_P, _I, _I, _I, _P, _I, _I)),
}


def find_compiler() -> str:
  """The host C++ compiler: ``$CXX``, else ``g++`` or ``c++`` on PATH."""
  for name in (os.environ.get("CXX"), "g++", "c++"):
    path = name and shutil.which(name)
    if path:
      return path
  raise RuntimeError("no C++ compiler ($CXX, g++ or c++) on PATH; the data "
                     "loader's host helper cannot be built")


def library_path(compiler: str) -> pathlib.Path:
  version = subprocess.run([compiler, "--version"], capture_output=True,
                           text=True, check=True).stdout
  h = hashlib.sha256(SOURCE.read_bytes())
  h.update(" ".join(CXX_FLAGS).encode())
  h.update(version.encode())
  return BUILD_DIR / f"libfastio_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
  """Compiles the helper unless its library exists; returns its path."""
  compiler = find_compiler()
  target = library_path(compiler)
  if target.exists():
    return target
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".tmp-", suffix=".so")
  os.close(fd)
  try:
    cmd = [compiler, *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
      raise RuntimeError(f"building the host helper failed "
                         f"({proc.returncode}):\n{' '.join(cmd)}\n"
                         f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
  finally:
    if os.path.exists(tmp):
      os.remove(tmp)
  return target


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
  """The helper's library, built on first use and loaded once per
  process, with the types of ``SIGNATURES`` set on each entry point."""
  lib = ctypes.CDLL(str(build()))
  for name, (restype, argtypes) in SIGNATURES.items():
    fn = getattr(lib, name)
    fn.restype = restype
    fn.argtypes = list(argtypes)
  return lib

"""``build.SIGNATURES`` and ``data.native.SIGNATURES`` against the sources
they describe, on the CPU.

``ctypes`` trusts the argument types it is given: a missing argument or
an ``int`` where the source takes a pointer shows only on the card, as a
wrong result or a pointer cut to 32 bits.  So every ``extern "C"``
function of ``csrc/*.cu`` is parsed here, and its arguments' count and
kinds (pointer, int, float) are held against the ctypes table; and so is
every one of the data loader's host helper, ``csrc/host/fastio.cpp``,
with its return type and its integers' widths.
"""

import ctypes
import re

import pytest

from xmcgan_image_generation_tpu_torch.data import native
from xmcgan_image_generation_tpu_torch.ops.cuda import build

_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_float: "float"}


def _extern_c_functions():
  """name -> argument kinds of every function in the sources' extern "C"
  blocks (each returns int)."""
  found = {}
  for src in sorted(build.CSRC_DIR.glob("*.cu")):
    text = re.sub(r"//[^\n]*", "", src.read_text())
    for block in text.split('extern "C" {')[1:]:
      # Definitions start at the beginning of a line; statements inside
      # them are indented.
      for ret, name, args in re.findall(
          r"^(\w+)\s+(\w+)\s*\(([^)]*)\)\s*\{", block, re.M):
        assert ret == "int", f"{src.name}: {name} returns {ret}"
        kinds = []
        for arg in filter(None, (a.strip() for a in args.split(","))):
          if "*" in arg:
            kinds.append("pointer")
          elif re.match(r"(const\s+)?int\b", arg):
            kinds.append("int")
          elif re.match(r"(const\s+)?float\b", arg):
            kinds.append("float")
          else:
            raise AssertionError(f"{src.name}: {name}: argument {arg!r}")
        assert name not in found, f"{name} is defined twice"
        found[name] = kinds
  return found


def test_sources_export_what_the_table_names():
  found = _extern_c_functions()
  assert found, "no extern \"C\" function found in csrc/"
  assert sorted(found) == sorted(build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_argument_kinds_match(name):
  found = _extern_c_functions()
  want = [_KIND[t] for t in build.SIGNATURES[name]]
  assert found.get(name) == want, (name, found.get(name), want)


_HOST_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
              ctypes.c_int64: "int64_t", ctypes.c_uint64: "uint64_t",
              ctypes.c_uint32: "uint32_t"}


def _host_functions():
  """name -> (return type, argument kinds) of the host helper's extern "C"
  block."""
  text = re.sub(r"//[^\n]*", "", native.SOURCE.read_text())
  block = text.split('extern "C" {')[1]
  found = {}
  for ret, name, args in re.findall(
      r"^(\w+)\s+(\w+)\s*\(([^)]*)\)\s*\{", block, re.M):
    kinds = []
    for arg in (a.strip() for a in args.split(",")):
      if "*" in arg:
        kinds.append("pointer")
      else:
        kind = re.match(r"(?:const\s+)?(int|int64_t|uint64_t)\s+\w+$", arg)
        assert kind, f"{name}: argument {arg!r}"
        kinds.append(kind.group(1))
    assert name not in found, f"{name} is defined twice"
    found[name] = (ret, kinds)
  return found


def test_host_helper_exports_what_the_table_names():
  assert sorted(_host_functions()) == sorted(native.SIGNATURES)


@pytest.mark.parametrize("name", sorted(native.SIGNATURES))
def test_host_helper_types_match(name):
  restype, argtypes = native.SIGNATURES[name]
  want = (_HOST_KIND[restype], [_HOST_KIND[t] for t in argtypes])
  assert _host_functions()[name] == want

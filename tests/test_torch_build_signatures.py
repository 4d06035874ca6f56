"""``build.SIGNATURES`` against the sources it describes, on the CPU.

``ctypes`` trusts the argument types it is given: a missing argument or
an ``int`` where the source takes a pointer shows only on the card, as a
wrong result or a pointer cut to 32 bits.  So every ``extern "C"``
function of ``csrc/*.cu`` is parsed here, and its arguments' count and
kinds (pointer, int, float) are held against the ctypes table.
"""

import ctypes
import re

import pytest

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

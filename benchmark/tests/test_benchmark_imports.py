"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port either: each import's top-level
name (the part before the first dot) is compared whole, since the port's
name begins with the JAX package's."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "optax", "xmcgan_image_generation_tpu"}
PORT = "xmcgan_image_generation_tpu_torch"
MODULES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: pathlib.Path):
  names = set()
  for node in ast.walk(ast.parse(path.read_text(), str(path))):
    if isinstance(node, ast.Import):
      names.update(alias.name.split(".")[0] for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      names.add(node.module.split(".")[0])
  return names


def test_the_scan_sees_every_module():
  assert len(MODULES) >= 20
  assert top_level_imports(BENCH / "run.py") >= {"torch", "benchmark"}


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax(path):
  assert not top_level_imports(path) & JAX


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
  assert PORT not in top_level_imports(path)
  assert not top_level_imports(path) & JAX


def test_the_names_are_compared_whole():
  # The port's name begins with the JAX package's: a prefix test would
  # flag every import of the port.
  assert PORT.startswith("xmcgan_image_generation_tpu")
  assert PORT not in JAX

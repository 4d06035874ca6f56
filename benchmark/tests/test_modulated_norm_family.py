"""The modulated-norm family's names and its metric, on made-up events:
each kernel name, bare and as the profiler spells a template instance,
falls in the reduction group (so ``elementwise_ms.train`` keeps counting
the layer's work), and ``norm_ms.train`` reads the family's device ms a
step, and None without a launch."""

import importlib
import types

import pytest

from benchmark import cells
from benchmark import trace
from benchmark.kernels import modulated_norm as family


@pytest.mark.parametrize("name", family.NAMES)
def test_names_fall_in_the_reduction_group(name):
  assert "norm" in name
  for spelled in (name, f"void (anonymous namespace)::{name}<__nv_bfloat16>"
                  f"(__nv_bfloat16 const*, float const*, float*, "
                  f"unsigned int*, (anonymous namespace)::Shape, int)"):
    assert trace.group(spelled) == "reduction"


def test_counters_name_the_port_stages():
  assert set(family.COUNTERS) == {"stats", "apply", "bwd_reduce", "bwd_dx"}
  for module, attr in family.COUNTERS.values():
    assert isinstance(
        getattr(importlib.import_module(module), attr).launches, int)


def _record(counters, steps=2):
  ops = [("void (anonymous namespace)::modnorm_apply<float>(float const*)",
          0, 3_000_000),
         ("void (anonymous namespace)::modnorm_bwd_dx<float>(float const*)",
          5_000_000, 6_000_000),
         ("void at::native::reduce_kernel<512, 1>", 7_000_000, 9_000_000)]
  return types.SimpleNamespace(
      kind="train", steps=steps, counters=counters,
      trace=trace.Trace(ops=ops, start_ns=0, end_ns=10_000_000, spans=[]))


def test_norm_ms_reads_the_family_a_step():
  read = cells.reader("norm_ms.train").read
  launched = {f"modulated_norm.{op}": 4 for op in family.COUNTERS}
  assert read(_record(launched)) == pytest.approx(2.0)
  assert read(_record({k: 0 for k in launched})) is None
  assert read(_record({})) is None
  assert read(types.SimpleNamespace(kind="train", steps=2, counters=launched,
                                    trace=None)) is None

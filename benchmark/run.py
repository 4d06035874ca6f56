"""Runs one cell of the benchmark once and prints one JSON line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for (``chips`` in ``workloads/<cell>.json``).  Set-up makes the
cell's weights and inputs from ``--seed`` and warms up every shape; the
window then measures for ``--seconds``.  With ``--trace 0`` the line
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a ``torch.profiler`` trace of the window and the
harness's spans and counters.  After the window the program is freed and
the reference (`benchmark.reference`) checks what the timed path
produced (`benchmark.compare`); ``correct`` says whether every number is
within the cell's limit, and the numbers with their limits close the
standard error and the line (``checks``).  ``built_kernels`` says whether
this run's set-up built the port's CUDA kernels (a checkout's first run),
so that its ``setup_s`` can be told apart.

Exits with a non-zero code and prints no line when there is no card, or
fewer than the cell needs, and when JAX or the JAX package was imported.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
  sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import cells, compare, trace  # noqa: E402

# Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "xmcgan_image_generation_tpu")


def forbidden_modules():
  return sorted({name.split(".")[0] for name in sys.modules}
                & set(FORBIDDEN))


def card() -> str:
  """The card's name and power limit, as ``nvidia-smi`` reads them."""
  try:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
  except (OSError, subprocess.SubprocessError):
    return "unknown"
  return out[0] if out else "unknown"


def kernel_counters():
  """Launches so far of each kernel family of ``kernels/``, by
  ``<family>.<op>``: the port's own counters."""
  import importlib

  out = {}
  for path in sorted((cells.HERE / "kernels").glob("*.py")):
    if path.stem.startswith("_"):
      continue
    family = importlib.import_module(f"benchmark.kernels.{path.stem}")
    for op, (module, attr) in family.COUNTERS.items():
      out[f"{path.stem}.{op}"] = getattr(importlib.import_module(module),
                                         attr).launches
  return out


def kernel_libraries():
  """The port's built kernel libraries: a run that adds one has built the
  kernels in its set-up (a checkout's first run)."""
  from xmcgan_image_generation_tpu_torch.ops.cuda import build

  return set(build.BUILD_DIR.glob("*.so"))


class Context:
  """What a traffic driver is handed: the cell, its configuration (the
  port's ``config`` and the same as a plain dict, ``cfg``), the mix, the
  seed, the window's length, and the hooks around the window."""

  def __init__(self, cell, config_file, mix, seed, seconds, traced, device,
               start):
    self.cell = cell
    self.config = cells.port_config(config_file)
    self.cfg = dict(self.config)
    self.mix = mix
    self.seed = seed
    self.seconds = seconds
    self.traced = traced
    self.device = torch.device(device)
    self.start = start
    self._counters = {}

  def new_record(self, kind):
    return types.SimpleNamespace(
        kind=kind, cell=self.cell, cfg=self.cfg, mix=self.mix, work=0,
        images=0, window_s=None, setup_s=None, trace=None, counters={},
        memory_peak_bytes=0)

  def start_window(self, record):
    self.synchronize()
    record.setup_s = time.perf_counter() - self.start
    if self.device.type == "cuda":
      torch.cuda.reset_peak_memory_stats(self.device)
    self._counters = kernel_counters()

  def tracing(self):
    return trace.Tracer() if self.traced else contextlib.nullcontext()

  def synchronize(self):
    if self.device.type == "cuda":
      torch.cuda.synchronize(self.device)

  def end_window(self, record, tracer, start_ns, end_ns, spans):
    after = kernel_counters()
    record.counters = {k: after[k] - self._counters.get(k, 0) for k in after}
    if self.device.type == "cuda":
      record.memory_peak_bytes = torch.cuda.max_memory_allocated(self.device)
    if tracer is not None:
      record.trace = tracer.trace(start_ns, end_ns, spans)


def execute(cell, seed, seconds, traced, device, start, files=None):
  """One run of ``cell``: returns the result's dict (``checks`` last).
  ``files`` may give the cell's ``workload``, ``config``, ``mix`` and
  ``benchmark`` data in place of the files (the tests' small sizes)."""
  files = files or {}
  cell_file = files.get("workload") or cells.workload(cell)
  config_file = files.get("config") or cells.config(cell_file["config"])
  mix = files.get("mix") or cells.mix(cell_file["traffic"])
  bench = files.get("benchmark") or cells.benchmark()
  driver = cells.driver(mix["kind"])
  ctx = Context(cell, config_file, mix, seed, seconds, traced, device, start)
  record, produced = driver.run(ctx)
  if traced and record.trace is not None:
    print(f"traced window: {record.work} {mix['kind']} units, "
          f"{record.images / record.window_s:.4f} images/s with the "
          f"profiler on ({len(record.trace.ops)} device operations)",
          file=sys.stderr, flush=True)
  metrics = {}
  for metric in cells.metrics_of(bench, cell, traced):
    value = cells.reader(metric["name"]).read(record)
    if value is None:
      if not traced:
        raise RuntimeError(f"{metric['name']} has no value in {cell}")
      continue
    metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
  start = time.perf_counter()
  numbers = driver.check(ctx, produced)
  print(f"reference check: {time.perf_counter() - start:.1f} s",
        file=sys.stderr, flush=True)
  checks = compare.judge(numbers, cell_file["limits"])
  dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
         "kind": (torch.cuda.get_device_name(ctx.device)
                  if ctx.device.type == "cuda" else "cpu"),
         "count": cell_file["chips"],
         "memory_peak_bytes": record.memory_peak_bytes}
  result = {"correct": compare.passed(checks), "attempted": record.work,
            "failed": 0, "metrics": metrics, "device": dev}
  if record.trace is not None:
    dev["busy_s"] = record.trace.busy_s
    dev["window_s"] = record.trace.window_s
    result["breakdown"] = record.trace.breakdown()
  result["checks"] = checks
  return result


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--workload", required=True)
  parser.add_argument("--seed", type=int, required=True)
  parser.add_argument("--seconds", type=float, required=True)
  parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = parser.parse_args(argv)
  chips = cells.workload(args.workload)["chips"]
  if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
    print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
          f"{torch.cuda.device_count()} visible", file=sys.stderr)
    return 2
  name = card()
  print(f"card: {name}", file=sys.stderr, flush=True)
  libraries = kernel_libraries()
  result = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", _START)
  found = forbidden_modules()
  if found:
    print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
    return 3
  result["card"] = name
  result["built_kernels"] = bool(kernel_libraries() - libraries)
  print(f"kernels built in this run's set-up: {result['built_kernels']}",
        file=sys.stderr)
  result["checks"] = result.pop("checks")
  for label, c in result["checks"].items():
    print(f"check {label}: {c['value']!r} (limit {c['limit']!r})",
          file=sys.stderr)
    if not math.isfinite(c["value"]):
      c["value"] = str(c["value"])
  sys.stderr.flush()
  print(json.dumps(result), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())

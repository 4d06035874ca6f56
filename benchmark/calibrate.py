"""Readings from which a cell's limits are set: the comparison's numbers
for many seeds in one process, of the program, of the control, or of the
program with a fault planted under its timed path.

    python benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --mode program|control|unchanged|half [--seconds S]

``program`` runs set-up and the verified steps (training) or a window of
``--seconds`` (serving) and compares with the reference, as a benchmark
run does; ``control`` puts the reference, computed in float8
(`reference.layers.fp8_rounding`), in the program's place, and ``bf16``
the reference in bfloat16 (a witness of what rounding alone gives);
``--set dtype='"float32"'`` runs the program in float32 (another);
``unchanged`` and ``half`` plant `faults` under the training step.  One
JSON line a seed.  A benchmark run never runs this.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
  sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import cells, compare, faults, run  # noqa: E402
from benchmark.reference import layers  # noqa: E402


ROUNDING = {"control": layers.fp8_rounding, "bf16": layers.bf16_rounding}


def readings(cell, seed, mode, seconds, where, settings):
  workload = cells.workload(cell)
  mix = cells.mix(workload["traffic"])
  driver = cells.driver(mix["kind"])
  serving = mix["kind"] == "serve"
  config = cells.config(workload["config"])
  config["config"].update(settings)
  ctx = run.Context(cell, config, mix, seed, seconds if serving else 0.0,
                    False, "cuda", time.perf_counter())
  if mode in ROUNDING:
    rounding = ROUNDING[mode]
    if serving:
      indices = list(range(mix["pool"]))
      control = driver.reference_images(ctx, indices, rounding)
      return driver.check(ctx, [control[i] for i in indices])
    control = driver.reference(ctx, rounding=rounding)
    exact = driver.reference(ctx)
    where["losses"] = [control.losses, exact.losses]
    return compare.train_numbers(control, exact, where)
  if mode in faults.TRAINING:
    from xmcgan_image_generation_tpu_torch import train as train_lib

    real = train_lib.train_step
    train_lib.train_step = faults.TRAINING[mode](real)
    try:
      _, produced = driver.run(ctx)
    finally:
      train_lib.train_step = real
  else:
    _, produced = driver.run(ctx)
  if serving:
    return driver.check(ctx, produced)
  exact = driver.reference(ctx)
  where["losses"] = [produced.losses, exact.losses]
  return compare.train_numbers(produced, exact, where)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--workload", required=True)
  parser.add_argument("--seeds", required=True)
  parser.add_argument("--mode", default="program",
                      choices=["program"] + sorted(ROUNDING)
                      + sorted(faults.TRAINING))
  parser.add_argument("--seconds", type=float, default=15.0)
  parser.add_argument("--set", action="append", default=[],
                      help="KEY=JSON over the configuration (a witness: "
                           "dtype=\"float32\")")
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print("calibrate needs a CUDA card", file=sys.stderr)
    return 2
  settings = {}
  for item in args.set:
    key, _, value = item.partition("=")
    settings[key] = json.loads(value)
  for seed in [int(s) for s in args.seeds.split(",")]:
    start = time.perf_counter()
    where = {}
    numbers = readings(args.workload, seed, args.mode, args.seconds, where,
                       settings)
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "settings": settings,
                      "seed": seed, "numbers": numbers, "where": where,
                      "seconds": time.perf_counter() - start}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())

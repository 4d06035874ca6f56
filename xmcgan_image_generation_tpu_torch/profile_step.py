"""Times and profiles a training step on one GPU.

``python -m xmcgan_image_generation_tpu_torch.profile_step
[--config=default|FILE[:VARIANT]] [--config.KEY=VALUE ...]``

The configuration is read as `main` reads it (the flagship by default;
``--config=xmcgan_image_generation_tpu_torch/configs/coco_xmc_256.py
--config.grad_accum_steps=2`` for the 256 px step), on the synthetic
source.

TF32 is off for matmuls and convolutions, as in ``chip_smoke.py``.  Each
step is `train.timed_step`, the loop of `train.train`: take the next
super-batch of the synthetic source from the prefetcher (the loader's
workers make it while the card runs), take the outer step, synchronize.

1. Sets up two runs of the configuration (the flagship: 128 px, 2 x 56,
   bfloat16, synthetic data from the config's seed): one with
   ``use_pallas`` on (the CUDA kernels), one off (the einsum heads).  After 2 warm-up steps each it
   times 5 outer steps per arm, in the order on, off, off, on and then
   off, on, on, off, for 3 rounds, and prints each arm's step times with
   their median and quartiles.
2. Profiles 5 steps of the kernel arm with ``torch.profiler`` and prints
   the device time per step by kernel and by group of kernels.  Their sum
   over the unprofiled median step is the device's busy share; the
   profiled window itself is longer by the profiler's own cost.

Prints one JSON line at the end.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from xmcgan_image_generation_tpu_torch import main as main_lib
from xmcgan_image_generation_tpu_torch import train as train_lib

ROUNDS, STEPS, WARMUP, TOP = 3, 5, 2, 25
# Kernel-name fragments of each group, first match wins.
GROUPS = (
    ("port kernels (ntxent, word_scores)",
     ("ntxent_", "scores_fwd", "scores_drn", "scores_dwn", "scores_gemm",
      "sum_parts")),
    ("convolution", ("conv", "cudnn", "implicit", "dgrad", "wgrad", "fprop",
                     "xmma", "nchw", "nhwc")),
    ("matmul", ("gemm", "cutlass", "sm90", "ampere", "splitk")),
    ("optimizer", ("multi_tensor", "adam", "foreach")),
    ("reduction", ("reduce", "norm", "softmax", "logsumexp")),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "cat",
                            "fill", "index", "upsample", "pool")),
)


def _group(name: str) -> str:
  low = name.lower()
  for group, keys in GROUPS:
    if any(k in low for k in keys):
      return group
  return "other"


def _arm(base, use_pallas: bool, device):
  config = type(base)(base)
  config.data_source = "synthetic"
  config.use_pallas = use_pallas
  run, _ = train_lib.setup(config, device)

  def step() -> float:
    return train_lib.timed_step(run, config, device)[1]

  return config, step


def _quartiles(xs):
  q = statistics.quantiles(xs, n=4, method="inclusive")
  return {"median": statistics.median(xs), "q1": q[0], "q3": q[2],
          "n": len(xs)}


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--config", default="default")
  args, overrides = parser.parse_known_args(argv)
  base = main_lib.config_from_args(parser, args.config, overrides)
  if not torch.cuda.is_available():
    raise SystemExit("profile_step needs a CUDA device")
  device = torch.device("cuda")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=True).stdout.strip().splitlines()[0]
  print(f"card: {card}; TF32 off (matmul and cuDNN); {base.image_size} px, "
        f"{base.d_step_per_g_step} x {base.batch_size}, grad_accum_steps "
        f"{base.grad_accum_steps}, remat {base.remat} (min resolution "
        f"{base.remat_min_resolution}, {base.remat_policy})", flush=True)

  config, on = _arm(base, True, device)
  _, off = _arm(base, False, device)
  for fn in (on, off):
    for _ in range(WARMUP):
      fn()
  times = {"kernels": [], "einsum": []}
  arms = {"kernels": on, "einsum": off}
  for r in range(ROUNDS):
    first, second = ("kernels", "einsum")[::1 if r % 2 == 0 else -1]
    for name in (first, second, second, first):
      times[name] += [arms[name]() for _ in range(STEPS)]
  images = config.batch_size * config.d_step_per_g_step
  summary = {name: _quartiles([t * 1e3 for t in ts])
             for name, ts in times.items()}
  for name, q in summary.items():
    print(f"{name}: step ms median {q['median']:.2f} (q1 {q['q1']:.2f}, "
          f"q3 {q['q3']:.2f}, n {q['n']}), "
          f"{images / (q['median'] / 1e3):.2f} img/s", flush=True)

  # The card's activity alone: with the host's recorded too, the
  # optimizer's ``record_function`` range (``Optimizer.step#...``) comes
  # back as one more device event over its kernels, counting their time
  # twice.
  torch.cuda.synchronize(device)
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    start = time.perf_counter()
    for _ in range(STEPS):
      on()
    window = time.perf_counter() - start
  kernels = {}
  for evt in prof.key_averages():
    dev_us = evt.self_device_time_total
    if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
      calls, total = kernels.get(evt.key, (0, 0.0))
      kernels[evt.key] = (calls + evt.count, total + dev_us)
  busy_ms = sum(us for _, us in kernels.values()) / 1e3
  share = busy_ms / STEPS / summary["kernels"]["median"]
  print(f"profiled window: {window * 1e3:.2f} ms for {STEPS} steps; "
        f"device time {busy_ms / STEPS:.2f} ms/step = {100 * share:.1f}% "
        f"of the unprofiled median step", flush=True)
  groups = {}
  for name, (_, us) in kernels.items():
    groups[_group(name)] = groups.get(_group(name), 0.0) + us / 1e3
  for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
    print(f"  {name}: {ms / STEPS:.2f} ms/step "
          f"({100 * ms / busy_ms:.1f}% of device time)")
  print(f"top {TOP} kernels by device time (ms/step, calls/step):")
  for name, (calls, us) in sorted(kernels.items(),
                                  key=lambda kv: -kv[1][1])[:TOP]:
    print(f"  {us / 1e3 / STEPS:9.3f}  {calls / STEPS:6.1f}  "
          f"{name[:110]}")
  print(json.dumps({
      "card": card, "images_per_step": images,
      "step_ms": summary,
      "window_ms": window * 1e3, "device_ms_per_step": busy_ms / STEPS,
      "device_busy_share": share,
      "groups_ms_per_step": {k: v / STEPS for k, v in groups.items()},
  }))


if __name__ == "__main__":
  main()

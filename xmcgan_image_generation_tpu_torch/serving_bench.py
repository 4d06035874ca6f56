"""Serving throughput: the loaded artifact against eager G (the JAX
package's ``tools/serving_bench.py``).

Times the generator's inference two ways at each batch size:

  1. eager: `utils.serving.ServingGenerator`, G in eval mode run op by op
     in the framework;
  2. the artifact: one symbolic-batch export of the same module, saved
     with ``torch.export.save`` and loaded back with ``torch.export.load``
     as a consumer runs it.

Both run the same operations on the same weights, so a gap is the
artifact's calling overhead.  Each path is timed in ``--windows`` windows
of ``--steps`` calls after a warm-up call: CUDA events around each window
on the card, the host clock with ``--device=cpu``.  Prints one JSON line
with the device, each window's ms per batch, and images/s from the median
window.  ``--sizes`` also exports float32, bfloat16 and int8 artifacts of
the same weights and reports their bytes and the int8-vs-bf16 and
bf16-vs-f32 max |difference| of their images.

Usage (random weights from the configuration's seed unless ``--workdir``
has a checkpoint)::

  python -m xmcgan_image_generation_tpu_torch.serving_bench \\
      [--config_module coco_xmc[:variant]] [--workdir DIR] \\
      [--batch_sizes 1,8,56] [--steps 20] [--windows 5] [--sizes] \\
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import tempfile
import time
from typing import Callable, List, Tuple

import torch

from xmcgan_image_generation_tpu_torch.utils import serving

log = logging.getLogger("xmcgan_torch")


def random_inputs(config, batch: int, seed: int, device
                  ) -> Tuple[torch.Tensor, ...]:
  """The four serving inputs: normal sentence and word features, caption
  lengths 3..17 and a normal latent, drawn from ``seed``."""
  g = torch.Generator().manual_seed(seed)
  return tuple(x.to(device) for x in (
      torch.randn(batch, serving.BERT_DIM, generator=g),
      torch.randn(batch, serving.COCO_MAX_TEXT_LENGTH, serving.BERT_DIM,
                  generator=g),
      torch.randint(3, serving.COCO_MAX_TEXT_LENGTH + 1, (batch, 1),
                    generator=g).float(),
      torch.randn(batch, config.z_dim, generator=g)))


def time_windows(fn: Callable, inputs, steps: int, windows: int,
                 device: torch.device) -> List[float]:
  """ms per call of ``fn(*inputs)`` in each of ``windows`` windows of
  ``steps`` calls, after one warm-up call: CUDA events on the card, the
  host clock on the CPU."""
  out = []
  with torch.no_grad():
    fn(*inputs)
    for _ in range(windows):
      if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(steps):
          fn(*inputs)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / steps)
      else:
        t0 = time.perf_counter()
        for _ in range(steps):
          fn(*inputs)
        out.append((time.perf_counter() - t0) * 1e3 / steps)
  return out


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
  return float((a.double() - b.double()).abs().max())


def artifact_sizes(config, state, inputs, directory: str, device) -> dict:
  """Bytes of the float32, bfloat16 and int8 artifacts of the EMA weights
  and the max |difference| of their images on ``inputs``."""
  sizes, images = {}, {}
  for name, dtype, quantize in (("f32", "float32", None),
                                ("bf16", "bfloat16", None),
                                ("int8", "bfloat16", "int8")):
    variant = type(config)(config)
    variant.dtype = dtype
    path = os.path.join(directory, f"generator_{name}.pt2")
    torch.export.save(serving.export_generator(
        state.generator, state.ema_params, variant, quantize=quantize,
        device=device), path)
    sizes[name] = os.path.getsize(path)
    with torch.no_grad():
      images[name] = serving.load_exported(path).module()(*inputs)
    log.info("artifact %s: %d bytes", name, sizes[name])
  return {"artifact_bytes": sizes,
          "int8_max_abs_dev_vs_bf16": _max_abs(images["int8"],
                                               images["bf16"]),
          "bf16_max_abs_dev_vs_f32": _max_abs(images["bf16"], images["f32"])}


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--config_module", default="coco_xmc")
  p.add_argument("--workdir", default=None,
                 help="training workdir with checkpoints (default: random "
                      "weights, timing only)")
  p.add_argument("--batch_sizes", default="1,8,56")
  p.add_argument("--steps", type=int, default=20)
  p.add_argument("--windows", type=int, default=5)
  p.add_argument("--sizes", action="store_true",
                 help="also export f32/bf16/int8 artifacts and report their "
                      "bytes and the int8 output deviation")
  p.add_argument("--device", default="cuda")
  args = p.parse_args(argv)
  logging.basicConfig(level=logging.INFO)

  from xmcgan_image_generation_tpu_torch.engine.state import (
      create_train_state,
  )
  from xmcgan_image_generation_tpu_torch.utils.checkpoint import (
      CheckpointManager,
      checkpoints_dir,
  )

  device = serving.check_device(args.device)
  config = serving.load_config_module(args.config_module)
  state = create_train_state(config, device, seed=config.seed)
  step = None
  if args.workdir:
    ckpt = CheckpointManager(checkpoints_dir(args.workdir))
    step = ckpt.latest_step()
    if step is not None:
      ckpt.restore(step, state)
  batch_sizes = [int(b) for b in args.batch_sizes.split(",") if b]
  eager = serving.ServingGenerator(config, state.generator,
                                   state.ema_params).to(device)
  result = {
      "metric": f"xmcgan-{config.image_size}px generator serving "
                f"throughput ({config.dtype}, EMA weights)",
      "device": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
      "checkpoint_step": step,
      "clock": "cuda events" if device.type == "cuda" else "host",
  }
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "generator.pt2")
    t0 = time.perf_counter()
    torch.export.save(serving.export_generator(
        state.generator, state.ema_params, config, device=device), path)
    result["export_and_save_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    artifact = serving.load_exported(path).module()
    result["load_seconds"] = time.perf_counter() - t0
    result["artifact_bytes"] = os.path.getsize(path)
    per_batch = {}
    for b in batch_sizes:
      inputs = random_inputs(config, b, b, device)
      eager_ms = time_windows(eager, inputs, args.steps, args.windows,
                              device)
      artifact_ms = time_windows(artifact, inputs, args.steps,
                                 args.windows, device)
      with torch.no_grad():
        dev = _max_abs(artifact(*inputs), eager(*inputs))
      per_batch[str(b)] = {
          "eager_ms_windows": eager_ms,
          "artifact_ms_windows": artifact_ms,
          "images_per_sec_eager": b / statistics.median(eager_ms) * 1e3,
          "images_per_sec_artifact": (b / statistics.median(artifact_ms)
                                      * 1e3),
          "artifact_max_abs_dev_vs_eager": dev,
      }
      log.info("batch %d: eager %.3f ms, artifact %.3f ms (median window)",
               b, statistics.median(eager_ms),
               statistics.median(artifact_ms))
    result["batches"] = per_batch
    if args.sizes:
      inputs = random_inputs(config, max(batch_sizes), 0, device)
      result["sizes"] = artifact_sizes(config, state, inputs, tmp, device)
  print(json.dumps(result))


if __name__ == "__main__":
  main()

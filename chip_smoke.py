#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the CUDA kernels from ``xmcgan_image_generation_tpu_torch/csrc``
   and prints the build time and ``-Xptxas -v`` lines;
3. holds each kernel against its plain PyTorch version at the flagship
   shapes, with float32 and with bfloat16 inputs (TF32 off), and times
   both with CUDA events; then takes one small float32 step (test config)
   with the kernels and with the einsum heads and compares the losses;
4. trains the flagship configuration (128 px, 2 x 56 super-batch,
   bfloat16, every contrastive head and the ResNet-50 tower) for a few
   outer steps through ``train.train``, checks the losses are finite and
   that every kernel launched during the steps, and prints the step time,
   images/s and peak device memory;
5. prints one JSON line per kernel record, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero before the last line.  Without a CUDA
device, or outside a checkout, it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

WARMUP_STEPS = 2
TIMED_STEPS = 5
KERNEL_ITERS = 20


def fail(msg: str) -> None:
  print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
  sys.exit(1)


def card_line() -> str:
  proc = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, timeout=60, check=False)
  if proc.returncode != 0 or not proc.stdout.strip():
    fail(f"nvidia-smi: {proc.stderr.strip()}")
  return proc.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = KERNEL_ITERS) -> float:
  """Mean device time of ``fn()`` over ``iters`` calls, after warm-up."""
  import torch

  for _ in range(3):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def check_kernels(torch, records):
  """Phase 3: each kernel against its plain version at flagship shapes."""
  from xmcgan_image_generation_tpu_torch.ops.attention import padding_mask
  from xmcgan_image_generation_tpu_torch.ops.contrastive import l2_normalize
  from xmcgan_image_generation_tpu_torch.ops.cuda import ntxent
  from xmcgan_image_generation_tpu_torch.ops.cuda import word_scores as ws

  dev = torch.device("cuda")
  gen = torch.Generator(device=dev).manual_seed(0)
  batch, pool_dim, regions, words, dim = 56, 1536, 256, 17, 768
  g1 = g2 = 5.0

  def report(name, dtype, err, tol):
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name} [{dtype}]: max|kernel - plain| = {err:.3e} "
          f"(tolerance {tol:.1e}) {status}", flush=True)
    if err > tol:
      fail(f"{name} [{dtype}] disagrees with its plain version")

  # A: NT-Xent on post-ReLU-like pooled features.  Both sides reduce in
  # f32 from the same inputs; only the summation order differs.
  for dtype in (torch.float32, torch.bfloat16):
    a = torch.randn(batch, pool_dim, device=dev, generator=gen).abs()
    b = torch.randn(batch, pool_dim, device=dev, generator=gen)
    a, b = a.to(dtype), b.to(dtype)
    got = ntxent.ntxent_stats(a, b, 0.1)
    want = ntxent.ntxent_plain(a, b, 0.1)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    report("ntxent", str(dtype), err, 2e-4)
    if dtype == torch.float32:
      records["ntxent"]["max_abs_err"] = err
  a = torch.randn(batch, pool_dim, device=dev, generator=gen).bfloat16()
  b = torch.randn(batch, pool_dim, device=dev, generator=gen).bfloat16()
  records["ntxent"]["ms"] = time_ms(lambda: ntxent.ntxent_stats(a, b))
  records["ntxent"]["plain_ms"] = time_ms(lambda: ntxent.ntxent_plain(a, b))

  # B and C: word-region scores and their region gradient.
  max_len = torch.randint(3, words + 1, (batch, 1), device=dev,
                          generator=gen).float()
  mask = padding_mask(max_len, words).contiguous()
  word = torch.randn(batch, words, dim, device=dev, generator=gen)
  wn = l2_normalize(word).contiguous()
  for dtype in (torch.float32, torch.bfloat16):
    region = torch.randn(batch, regions, dim, device=dev,
                         generator=gen).to(dtype)
    rn = l2_normalize(region.float()).contiguous()
    got = ws.scores(rn, wn, mask, g1, g2)
    want = ws.scores_plain(rn, wn, mask, g1, g2)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    report("word_scores_fwd", str(dtype), err, 1e-4)
    if dtype == torch.float32:
      records["word_scores_fwd"]["max_abs_err"] = err

    # C through autograd: the public op (kernels B and C) against the
    # plain formulation, with one random cotangent.
    g = torch.randn(batch, batch, device=dev, generator=gen)
    x1 = region.clone().requires_grad_()
    ws.word_scores(x1, word, mask, g1, g2).backward(g)
    x2 = region.clone().requires_grad_()
    rn2 = l2_normalize(x2.float())
    ws.scores_plain(rn2, wn, mask, g1, g2).t().backward(g)
    torch.cuda.synchronize()
    ref = x2.grad.float()
    err = float((x1.grad.float() - ref).abs().max())
    # f32: summation order only.  bf16: the gradient is rounded to bf16 on
    # both sides, so one bf16 ulp (2^-8 relative) may separate them.
    rel = 1e-4 if dtype == torch.float32 else 8e-3
    report("word_scores_drn (autograd)", str(dtype), err,
           rel * float(ref.abs().max()))
    if dtype == torch.float32:
      saved = ws.new_saved(rn, wn)
      ws.scores(rn, wn, mask, g1, g2, saved)
      d_got = ws.drn(rn, wn, mask, g, saved, g1, g2)
      d_want = ws.drn_plain(rn, wn, mask, g, g1, g2)
      torch.cuda.synchronize()
      err = float((d_got - d_want).abs().max())
      report("word_scores_drn", str(dtype), err,
             1e-4 * float(d_want.abs().max()))
      records["word_scores_drn"]["max_abs_err"] = err

  # Timed as the training step runs them: the forward kernel (with the
  # regions' Gram matmul) saving what the region gradient starts from,
  # the gradient kernel reading it.  The plain backward is timed alone, on
  # a retained graph of the plain forward.
  region = torch.randn(batch, regions, dim, device=dev, generator=gen)
  rn = l2_normalize(region).contiguous()
  g = torch.randn(batch, batch, device=dev, generator=gen)
  saved = ws.new_saved(rn, wn)
  x = rn.clone().requires_grad_()
  s_plain = ws.scores_plain(x, wn, mask, g1, g2)
  records["word_scores_fwd"]["ms"] = time_ms(
      lambda: ws.scores(rn, wn, mask, g1, g2, saved))
  records["word_scores_fwd"]["plain_ms"] = time_ms(
      lambda: ws.scores_plain(rn, wn, mask, g1, g2))
  records["word_scores_drn"]["ms"] = time_ms(
      lambda: ws.drn(rn, wn, mask, g, saved, g1, g2))
  records["word_scores_drn"]["plain_ms"] = time_ms(
      lambda: torch.autograd.grad(s_plain, x, g.t(), retain_graph=True))
  for name, rec in records.items():
    print(f"  {name}: kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms", flush=True)

  def kernel_pair():
    ws.scores(rn, wn, mask, g1, g2, saved)
    return ws.drn(rn, wn, mask, g, saved, g1, g2)

  pair_ms = time_ms(kernel_pair)
  plain_pair_ms = time_ms(lambda: ws.drn_plain(rn, wn, mask, g, g1, g2))
  print(f"  word_scores forward + region gradient: kernels {pair_ms:.4f} "
        f"ms, plain (forward, then autograd backward) {plain_pair_ms:.4f} "
        f"ms", flush=True)


def check_small_step(torch):
  """Phase 3b: one outer step at the test config (32 px, float32) with the
  kernels and with the einsum heads, from the same seed: the losses must
  agree, since the kernels compute the heads' functions."""
  from xmcgan_image_generation_tpu_torch import train as train_lib
  from xmcgan_image_generation_tpu_torch.configs import coco_xmc

  losses = {}
  for use_pallas in (True, False):
    config = coco_xmc.get_test_config()
    config.update(dtype="float32", scale_fused_convs=True, num_train_steps=1,
                  use_pallas=use_pallas, batch_size=8)
    with tempfile.TemporaryDirectory() as workdir:
      train_lib.train(config, workdir, torch.device("cuda"))
      with open(os.path.join(workdir, "metrics.jsonl")) as f:
        losses[use_pallas] = json.loads(f.readline())
  worst = 0.0
  for key in ("d_loss", "g_loss", "c_loss_d", "c_loss_g"):
    got, want = losses[True][key], losses[False][key]
    if not (math.isfinite(got) and math.isfinite(want)):
      fail(f"small step: {key} is not finite ({got}, {want})")
    worst = max(worst, abs(got - want) / max(abs(want), 1e-6))
  # f32 on both sides, TF32 off: summation order only.
  print(f"phase 3b: test-config step, kernels against einsum heads: max "
        f"relative loss difference {worst:.3e} (tolerance 1e-4)", flush=True)
  if worst > 1e-4:
    fail("the kernel step disagrees with the einsum step at the test config")


def train_flagship(torch, records, card):
  """Phase 4: the flagship training step through train.train."""
  from xmcgan_image_generation_tpu_torch import train as train_lib
  from xmcgan_image_generation_tpu_torch.configs import coco_xmc
  from xmcgan_image_generation_tpu_torch.ops.cuda import ntxent
  from xmcgan_image_generation_tpu_torch.ops.cuda import word_scores as ws

  config = coco_xmc.get_config()
  config.data_source = "synthetic"
  config.num_train_steps = WARMUP_STEPS + TIMED_STEPS
  images_per_step = config.batch_size * config.d_step_per_g_step
  print(f"phase 4: train.train, {config.image_size}px, "
        f"{config.d_step_per_g_step} x {config.batch_size}, {config.dtype}, "
        f"use_pallas={config.use_pallas}, pretrained tower="
        f"{config.pretrained_image_contrastive}, "
        f"{config.num_train_steps} steps", flush=True)
  counters = {"ntxent": ntxent.ntxent_stats, "word_scores_fwd": ws.scores,
              "word_scores_drn": ws.drn}
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  for fn in counters.values():
    fn.launches = 0
  with tempfile.TemporaryDirectory() as workdir:
    train_lib.train(config, workdir, torch.device("cuda"))
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
      lines = [json.loads(line) for line in f]
  for name, fn in counters.items():
    records[name]["launches"] = fn.launches
  peak = torch.cuda.max_memory_allocated()
  for line in lines:
    print(f"  {json.dumps(line)}", flush=True)
  if len(lines) != config.num_train_steps:
    fail(f"{len(lines)} metric lines for {config.num_train_steps} steps")
  for line in lines:
    for key, value in line.items():
      if not math.isfinite(value):
        fail(f"step {line['step']}: {key} = {value}")
  for name, rec in records.items():
    print(f"  launches during the steps: {name} = {rec['launches']}")
    if rec["launches"] <= 0:
      fail(f"kernel {name} was not launched by the training steps")
  secs = sorted(line["seconds"] for line in lines[WARMUP_STEPS:])
  mean = sum(secs) / len(secs)
  data = [line["data_seconds"] for line in lines[WARMUP_STEPS:]]
  print(f"  step time over {len(secs)} steps after {WARMUP_STEPS} warm-up "
        f"(drawing the synthetic super-batch and moving it to the card "
        f"included): mean {mean * 1e3:.2f} ms, min {secs[0] * 1e3:.2f} ms, "
        f"max {secs[-1] * 1e3:.2f} ms ({card})", flush=True)
  print(f"  of which drawing and moving the batch: mean "
        f"{sum(data) / len(data) * 1e3:.2f} ms", flush=True)
  print(f"  throughput: {images_per_step / mean:.2f} img/s "
        f"({images_per_step} images per outer step)")
  print(f"  peak device memory: {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated)", flush=True)


def main() -> None:
  try:
    import torch
  except ImportError:
    fail("PyTorch is not installed")
  if not torch.cuda.is_available():
    fail("no CUDA device: this smoke test runs only on a GPU")
  root = os.path.dirname(os.path.abspath(__file__))
  if not os.path.isdir(os.path.join(root, "xmcgan_image_generation_tpu_torch",
                                    "csrc")):
    fail("run from the root of a checkout of the repository")
  sys.path.insert(0, root)

  card = card_line()
  name = torch.cuda.get_device_name(0)
  print(f"phase 1: card {card}; torch.cuda.get_device_name(0) = {name}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  print("  torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")

  from xmcgan_image_generation_tpu_torch.ops.cuda import build

  start = time.perf_counter()
  result = build.build()
  build.library()
  print(f"phase 2: built {result.path.name} in {result.seconds:.1f} s "
        f"({time.perf_counter() - start:.1f} s with loading)", flush=True)
  for line in result.log.splitlines():
    if "ptxas" in line:
      print(f"  {line.strip()}")

  src = "xmcgan_image_generation_tpu_torch/csrc/"
  pallas = "xmcgan_image_generation_tpu/ops/pallas/"
  records = {
      "ntxent": {"name": "ntxent", "route": "cuda",
                 "source": src + "ntxent.cu",
                 "replaces": pallas + "ntxent.py:51"},
      "word_scores_fwd": {"name": "word_scores_fwd", "route": "cuda",
                          "source": src + "word_scores.cu",
                          "replaces": pallas + "word_scores.py:44"},
      "word_scores_drn": {"name": "word_scores_drn", "route": "cuda",
                          "source": src + "word_scores.cu",
                          "replaces": pallas + "word_scores.py:185"},
  }
  print("phase 3: kernels against their plain versions, flagship shapes",
        flush=True)
  check_kernels(torch, records)
  check_small_step(torch)
  train_flagship(torch, records, card)

  print(json.dumps({"kernels": list(records.values())}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()

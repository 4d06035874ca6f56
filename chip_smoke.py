#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the CUDA kernels from ``xmcgan_image_generation_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and prints the build time and
   ``-Xptxas -v`` lines;
3. holds each kernel against its plain PyTorch version at the flagship
   shapes, with float32 and with bfloat16 inputs (TF32 off), on random
   regions and on peaked ones (built from their caption's words), the
   NT-Xent statistics and their gradient included, checks that two calls
   of each word-score gradient agree bit for bit, and times each kernel
   and its plain version with CUDA events, beside the same dense products
   through ``torch.bmm`` (a yardstick the port never calls); times the
   NT-Xent kernels and an empty kernel (the launch floor) also as device
   time by ``torch.profiler``;
   drives ``word_scores`` differentiated with respect to regions and
   words (kernels B, C and D) and checks that each launched; then takes
   one small float32 step (test config) with the kernels and with the
   einsum heads and compares the losses;
4. trains the flagship configuration (128 px, 2 x 56 super-batch,
   bfloat16, every contrastive head and the ResNet-50 tower) for a few
   outer steps through ``train.train``, checks the losses are finite and
   that kernels A (forward and backward), B and C launched during the
   steps, and prints the step
   time, images/s, peak device memory and the last step's checkpoint
   save;
5. trains the test configuration 2 steps, then resumes a fresh run from
   the step-1 checkpoint and checks its step 2 against the first run's;
6. scores phase 4's checkpoint with ``evaluate.evaluate_continuously``
   (the flagship G with normal and EMA weights, the full 299 px
   InceptionV3, ``eval_num`` cut to 2048) and prints the seconds, images
   per second, peak memory and the ``scores.csv`` row;
7. prints the kernel records as one JSON line, the card line, and last
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
EVAL_NUM = 2048          # of the configuration's 30000, to fit the limit
EVAL_AVG_NUM = 1         # of 3

# The least time of a kernel's work: the larger of its bytes (inputs read
# once, outputs written once) over the memory rate and its operations over
# the peak rate of its route, published for one H100 SXM at 700 W:
# float32 FMA on the CUDA cores, bfloat16 tensor cores, and float32
# products on the TF32 tensor cores in the 3xTF32 split (three TF32
# products each).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12,
                  "tf32x3": 495e12 / 3}


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


def device_ms(fn, names, iters: int = KERNEL_ITERS):
  """Mean device time per call of ``fn()`` by ``torch.profiler``: the
  kernels whose names hold one of ``names``, after warm-up; None when the
  profiler saw no device time."""
  import torch

  for _ in range(3):
    fn()
  torch.cuda.synchronize()
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    for _ in range(iters):
      fn()
    torch.cuda.synchronize()
  total_us = sum(
      evt.self_device_time_total for evt in prof.key_averages()
      if evt.device_type == torch.autograd.DeviceType.CUDA
      and any(name in evt.key for name in names))
  return total_us / iters / 1e3 if total_us > 0 else None


def set_bound(record, nbytes, ops, rate):
  t_bytes = nbytes / HBM_BYTES_PER_S
  t_ops = ops / PEAK_OPS_PER_S[rate]
  record["bound_ms"] = max(t_bytes, t_ops) * 1e3
  record["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
  return t_bytes * 1e3, ops / PEAK_OPS_PER_S["float32"] * 1e3


def word_scores_bounds(records, n, regions, words, dim, saved_bytes):
  """Bytes and operations of kernels B, C and D at these shapes (float32,
  n images and n captions).  B forms S = rn wn^T, the Gram matrix rn rn^T
  and G alpha; reads rn, wn and the mask; writes the scores and the
  record.  C forms E wn, H = alpha diag(b) alpha^T and H rn; reads rn, wn,
  the mask, g and the record; writes d_rn.  D forms E^T rn; reads rn, the
  mask, g and the record; writes d_wn.  All three take the 3xTF32 route.
  Returns each kernel's bytes-bound and float32-FMA-bound ms."""
  rn, wn = 4 * n * regions * dim, 4 * n * words * dim
  mask, scores = 4 * n * words, 4 * n * n       # g is the size of scores
  sim = 2 * n * n * regions * words * dim       # one [R, L, D] product per pair
  gram = 2 * n * regions * regions * dim
  g_alpha = 2 * n * n * words * regions * regions
  return {
      "word_scores_fwd": set_bound(
          records["word_scores_fwd"], rn + wn + mask + scores + saved_bytes,
          sim + gram + g_alpha, "tf32x3"),
      "word_scores_drn": set_bound(
          records["word_scores_drn"],
          rn + wn + mask + scores + saved_bytes + rn, sim + g_alpha + gram,
          "tf32x3"),
      "word_scores_dwn": set_bound(
          records["word_scores_dwn"], rn + mask + scores + saved_bytes + wn,
          sim, "tf32x3"),
  }


def check_kernels(torch, records):
  """Phase 3: each kernel against its plain version at flagship shapes."""
  from xmcgan_image_generation_tpu_torch.ops.attention import padding_mask
  from xmcgan_image_generation_tpu_torch.ops.contrastive import l2_normalize
  from xmcgan_image_generation_tpu_torch.ops.cuda import build
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

  def check_identical(name, label, first, second):
    identical = bool(torch.equal(first, second))
    print(f"  {name} [{label}]: two calls bit-identical: {identical}",
          flush=True)
    if not identical:
      fail(f"two {name} calls on the same inputs differ")

  errors = {"word_scores_fwd": 0.0, "word_scores_drn": 0.0,
            "word_scores_dwn": 0.0}

  # A: NT-Xent on post-ReLU-like pooled features, the statistics and their
  # gradient from the forward's record.  Both sides reduce in f32 from the
  # same inputs; only the summation order differs.  The cotangent of the
  # accuracy and the entropy is ignored.
  g_out = torch.tensor([1.7, 0.3, 0.2], device=dev)
  for dtype in (torch.float32, torch.bfloat16):
    a = torch.randn(batch, pool_dim, device=dev, generator=gen).abs()
    b = torch.randn(batch, pool_dim, device=dev, generator=gen)
    a, b = a.to(dtype), b.to(dtype)
    record = torch.empty(ntxent.record_floats(batch), device=dev)
    got = ntxent.ntxent_stats(a, b, 0.1, record)
    want = ntxent.ntxent_plain(a, b, 0.1)
    d_got = ntxent.ntxent_bwd(a, b, record, g_out, 0.1)
    d_want = ntxent.ntxent_bwd_plain(a, b, g_out[0], 0.1)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    report("ntxent", str(dtype), err, 2e-4)
    d_err = max(float((x.float() - y.float()).abs().max())
                for x, y in zip(d_got, d_want))
    scale = max(float(y.float().abs().max()) for y in d_want)
    # f32: summation order only.  bf16: both gradients are rounded to
    # bf16, so one bf16 ulp (2^-8 relative) may separate them.
    report("ntxent_bwd", str(dtype), d_err,
           (1e-4 if dtype == torch.float32 else 8e-3) * scale)
    if dtype == torch.float32:
      records["ntxent"]["max_abs_err"] = err
      records["ntxent_bwd"]["max_abs_err"] = d_err
  # Timed as the training step calls them (bf16): CUDA events around the
  # wrappers (host time when the host is slower than the card), and device
  # time by the profiler, beside an empty kernel timed both ways.
  a = torch.randn(batch, pool_dim, device=dev, generator=gen).bfloat16()
  b = torch.randn(batch, pool_dim, device=dev, generator=gen).bfloat16()
  record = torch.empty(ntxent.record_floats(batch), device=dev)
  lib = build.library()

  def empty():
    build.check(lib.xmc_empty_kernel(torch.cuda.current_stream().cuda_stream),
                "empty kernel")

  def fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"

  for name, kernel, fn, plain in (
      ("ntxent", "ntxent_fwd", lambda: ntxent.ntxent_stats(a, b, 0.1, record),
       lambda: ntxent.ntxent_plain(a, b, 0.1)),
      ("ntxent_bwd", "ntxent_bwd",
       lambda: ntxent.ntxent_bwd(a, b, record, g_out, 0.1),
       lambda: ntxent.ntxent_bwd_plain(a, b, g_out[0], 0.1))):
    records[name]["ms"] = time_ms(fn)
    records[name]["plain_ms"] = time_ms(plain)
    records[name]["device_ms"] = device_ms(fn, (kernel,))
    print(f"  {name}: {records[name]['ms']:.4f} ms a call with events around "
          f"the wrapper, {fmt(records[name]['device_ms'])} device time "
          f"(torch.profiler); plain {records[name]['plain_ms']:.4f} ms",
          flush=True)
  print(f"  launch floor, an empty kernel through ctypes: {time_ms(empty):.4f} "
        f"ms with events, {fmt(device_ms(empty, ('empty_kernel',)))} device "
        f"time (torch.profiler)", flush=True)
  # Forward: reads a and b (bfloat16), writes f32[3] and the record;
  # normalizes both and forms S = a b^T.  Backward: reads a, b, the record
  # and g, writes d_a and d_b (bfloat16); two [B, B] x [B, D] products.
  record_bytes = 4 * ntxent.record_floats(batch)
  set_bound(records["ntxent"], 2 * 2 * batch * pool_dim + 12 + record_bytes,
            2 * batch * batch * pool_dim + 6 * batch * pool_dim, "bfloat16")
  set_bound(records["ntxent_bwd"],
            4 * 2 * batch * pool_dim + record_bytes + 4,
            4 * batch * batch * pool_dim + 8 * batch * pool_dim, "bfloat16")

  # B, C and D: word-region scores and their two gradients, on random
  # regions and on peaked ones: 3 x a real word of the image's own caption
  # plus 0.5 x noise, which gives sharp alpha and |S| near 1, as trained
  # features do.
  max_len = torch.randint(3, words + 1, (batch, 1), device=dev,
                          generator=gen)
  mask = padding_mask(max_len.float(), words).contiguous()
  word = torch.randn(batch, words, dim, device=dev, generator=gen)
  wn = l2_normalize(word).contiguous()

  def peaked_regions():
    pick = (torch.rand(batch, regions, device=dev, generator=gen)
            * max_len).long()
    base = torch.gather(word, 1, pick[..., None].expand(-1, -1, dim))
    return 3 * base + 0.5 * torch.randn(batch, regions, dim, device=dev,
                                        generator=gen)

  for kind in ("random", "peaked"):
    for dtype in (torch.float32, torch.bfloat16):
      region = (torch.randn(batch, regions, dim, device=dev, generator=gen)
                if kind == "random" else peaked_regions()).to(dtype)
      label = f"{kind}, {dtype}"
      rn = l2_normalize(region.float()).contiguous()
      got = ws.scores(rn, wn, mask, g1, g2)
      want = ws.scores_plain(rn, wn, mask, g1, g2)
      torch.cuda.synchronize()
      err = float((got - want).abs().max())
      report("word_scores_fwd", label, err, 1e-4)
      if dtype == torch.float32:
        errors["word_scores_fwd"] = max(errors["word_scores_fwd"], err)

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
      # f32: summation order only.  bf16: the gradient is rounded to bf16
      # on both sides, so one bf16 ulp (2^-8 relative) may separate them.
      rel = 1e-4 if dtype == torch.float32 else 8e-3
      report("word_scores_drn (autograd)", label, err,
             rel * float(ref.abs().max()))
      if dtype == torch.float32:
        saved = ws.new_saved(rn, wn)
        ws.scores(rn, wn, mask, g1, g2, saved)
        d_got = ws.drn(rn, wn, mask, g, saved, g1, g2)
        d_again = ws.drn(rn, wn, mask, g, saved, g1, g2)
        d_want = ws.drn_plain(rn, wn, mask, g, g1, g2)
        torch.cuda.synchronize()
        err = float((d_got - d_want).abs().max())
        report("word_scores_drn", label, err,
               1e-4 * float(d_want.abs().max()))
        errors["word_scores_drn"] = max(errors["word_scores_drn"], err)
        check_identical("word_scores_drn", label, d_got, d_again)
        d_got = ws.dwn(rn, wn, mask, g, saved, g1, g2)
        d_again = ws.dwn(rn, wn, mask, g, saved, g1, g2)
        d_want = ws.dwn_plain(rn, wn, mask, g, g1, g2)
        torch.cuda.synchronize()
        err = float((d_got - d_want).abs().max())
        report("word_scores_dwn", label, err,
               1e-4 * float(d_want.abs().max()))
        errors["word_scores_dwn"] = max(errors["word_scores_dwn"], err)
        check_identical("word_scores_dwn", label, d_got, d_again)

      # D through autograd: both gradients asked at once (kernels B, C,
      # D) against plain autograd of the plain formulation; the peaked
      # regions' own words.
      word_in = (torch.randn(batch, words, dim, device=dev, generator=gen)
                 if kind == "random" else word).to(dtype)
      x1 = region.clone().requires_grad_()
      y1 = word_in.clone().requires_grad_()
      ws.word_scores(x1, y1, mask, g1, g2).backward(g)
      x2 = region.clone().requires_grad_()
      y2 = word_in.clone().requires_grad_()
      ws.scores_plain(l2_normalize(x2.float()), l2_normalize(y2.float()),
                      mask, g1, g2).t().backward(g)
      torch.cuda.synchronize()
      for what, got, ref in (("region_feat.grad", x1.grad, x2.grad),
                             ("word_feat.grad", y1.grad, y2.grad)):
        ref = ref.float()
        report(f"word_scores both gradients, {what}", label,
               float((got.float() - ref).abs().max()),
               rel * float(ref.abs().max()))
  for name, err in errors.items():
    records[name]["max_abs_err"] = err

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
  y = wn.clone().requires_grad_()
  s_plain_w = ws.scores_plain(rn, y, mask, g1, g2)
  records["word_scores_dwn"]["ms"] = time_ms(
      lambda: ws.dwn(rn, wn, mask, g, saved, g1, g2))
  records["word_scores_dwn"]["plain_ms"] = time_ms(
      lambda: torch.autograd.grad(s_plain_w, y, g.t(), retain_graph=True))
  other_bounds = word_scores_bounds(records, batch, regions, words, dim,
                                    saved.numel() * saved.element_size())
  for name, rec in records.items():
    line = (f"  {name}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
    if name in other_bounds:
      bytes_ms, fma_ms = other_bounds[name]
      line += (f"; bytes alone {bytes_ms:.4f} ms, float32 FMA on the CUDA "
               f"cores {fma_ms:.4f} ms")
    print(line, flush=True)

  # The same dense products as one torch.bmm each (float32, TF32 off):
  # C's [E ; -H]^T [wn ; rn] with K = 72-row caption groups + R, and B's
  # rn wn^T over all captions.  A yardstick only; the port never calls it.
  rows = -(-batch // (72 // words)) * 72 + regions
  a = torch.randn(batch, regions, rows, device=dev, generator=gen)
  b = torch.randn(batch, rows, dim, device=dev, generator=gen)
  c = torch.randn(batch, dim, batch * words, device=dev, generator=gen)
  yardstick = {
      f"drn [{batch}, {regions}, {rows}] x [{batch}, {rows}, {dim}]":
          time_ms(lambda: torch.bmm(a, b)),
      f"fwd [{batch}, {regions}, {dim}] x [{batch}, {dim}, {batch * words}]":
          time_ms(lambda: torch.bmm(rn, c)),
  }
  print(f"  gemm_yardstick_ms {json.dumps(yardstick)} (torch.bmm, float32, "
        f"TF32 off)", flush=True)

  def kernel_pair():
    ws.scores(rn, wn, mask, g1, g2, saved)
    return ws.drn(rn, wn, mask, g, saved, g1, g2)

  pair_ms = time_ms(kernel_pair)
  plain_pair_ms = time_ms(lambda: ws.drn_plain(rn, wn, mask, g, g1, g2))
  print(f"  word_scores forward + region gradient: kernels {pair_ms:.4f} "
        f"ms, plain (forward, then autograd backward) {plain_pair_ms:.4f} "
        f"ms", flush=True)

  # The public op differentiated with respect to both inputs, the entry
  # point of kernel D: every count from 0, read right after.
  counters = {"word_scores_fwd": ws.scores, "word_scores_drn": ws.drn,
              "word_scores_dwn": ws.dwn}
  x = region.clone().requires_grad_()
  y = torch.randn(batch, words, dim, device=dev, generator=gen,
                  requires_grad=True)
  for fn in counters.values():
    fn.launches = 0
  ws.word_scores(x, y, mask, g1, g2).backward(g)
  torch.cuda.synchronize()
  launches = {name: fn.launches for name, fn in counters.items()}
  print(f"  word_scores with both gradients: launches {launches}",
        flush=True)
  if not (torch.isfinite(x.grad).all() and torch.isfinite(y.grad).all()):
    fail("word_scores with both gradients: non-finite gradient")
  for name, count in launches.items():
    if count <= 0:
      fail(f"kernel {name} was not launched by word_scores' backward")
  records["word_scores_dwn"]["launches"] = launches["word_scores_dwn"]


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


def flagship_config():
  from xmcgan_image_generation_tpu_torch.configs import coco_xmc

  config = coco_xmc.get_config()
  config.data_source = "synthetic"
  config.num_train_steps = WARMUP_STEPS + TIMED_STEPS
  return config


def train_flagship(torch, records, card, workdir, config):
  """Phase 4: the flagship training step through train.train, in
  ``workdir``, which keeps the last step's checkpoint for phase 6."""
  from xmcgan_image_generation_tpu_torch import train as train_lib
  from xmcgan_image_generation_tpu_torch.ops.cuda import ntxent
  from xmcgan_image_generation_tpu_torch.ops.cuda import word_scores as ws

  images_per_step = config.batch_size * config.d_step_per_g_step
  print(f"phase 4: train.train, {config.image_size}px, "
        f"{config.d_step_per_g_step} x {config.batch_size}, {config.dtype}, "
        f"use_pallas={config.use_pallas}, pretrained tower="
        f"{config.pretrained_image_contrastive}, "
        f"{config.num_train_steps} steps", flush=True)
  # Training never differentiates the word features (BERT inputs), so
  # kernel D is not on this path: its launches come from phase 3.
  counters = {"ntxent": ntxent.ntxent_stats, "ntxent_bwd": ntxent.ntxent_bwd,
              "word_scores_fwd": ws.scores, "word_scores_drn": ws.drn}
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  for fn in counters.values():
    fn.launches = 0
  train_lib.train(config, workdir, torch.device("cuda"))
  for name, fn in counters.items():
    records[name]["launches"] = fn.launches
  peak = torch.cuda.max_memory_allocated()
  with open(os.path.join(workdir, "metrics.jsonl")) as f:
    lines = [json.loads(line) for line in f]
  with open(os.path.join(workdir, "checkpoints.jsonl")) as f:
    saves = [json.loads(line) for line in f]
  for line in lines:
    print(f"  {json.dumps(line)}", flush=True)
  if len(lines) != config.num_train_steps:
    fail(f"{len(lines)} metric lines for {config.num_train_steps} steps")
  for line in lines:
    for key, value in line.items():
      if not math.isfinite(value):
        fail(f"step {line['step']}: {key} = {value}")
  for name in counters:
    print(f"  launches during the steps: {name} = "
          f"{records[name]['launches']}")
    if records[name]["launches"] <= 0:
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
  if [save["step"] for save in saves] != [config.num_train_steps]:
    fail(f"checkpoints saved at steps {[s['step'] for s in saves]}, "
         f"expected the last step only")
  print(f"  checkpoint at step {saves[0]['step']} (outside the timed "
        f"steps): {saves[0]['seconds']:.2f} s, {saves[0]['bytes']} bytes "
        f"({saves[0]['bytes'] / 1e9:.3f} GB) ({card})", flush=True)


def check_resume(torch, dev):
  """Phase 5: the test config in float32 on ``dev``: 2 steps with a
  checkpoint after each; then a fresh run restored from the step-1
  checkpoint takes step 2, which must match the first run's."""
  import shutil

  from xmcgan_image_generation_tpu_torch import train as train_lib
  from xmcgan_image_generation_tpu_torch.configs import coco_xmc
  from xmcgan_image_generation_tpu_torch.utils import checkpoint

  config = coco_xmc.get_test_config()
  config.update(dtype="float32", num_train_steps=2, checkpoint_every_steps=1)
  with tempfile.TemporaryDirectory() as tmp:
    whole, resumed = os.path.join(tmp, "whole"), os.path.join(tmp, "resumed")
    want = train_lib.train(config, whole, dev)
    first = checkpoint.CheckpointManager(checkpoint.checkpoints_dir(whole))
    again = checkpoint.CheckpointManager(checkpoint.checkpoints_dir(resumed))
    os.makedirs(again.directory)
    shutil.copy(first.path(1), again.path(1))
    got = train_lib.train(config, resumed, dev)
    losses = []
    for workdir in (whole, resumed):
      with open(os.path.join(workdir, "metrics.jsonl")) as f:
        losses.append(json.loads(f.readlines()[-1]))
  if got.step != 2 or want.step != 2 or losses[1]["step"] != 2:
    fail(f"resume: steps {got.step} and {want.step}, expected 2")
  worst_loss = max(
      abs(losses[1][k] - losses[0][k]) / max(abs(losses[0][k]), 1e-6)
      for k in ("d_loss", "g_loss", "c_loss_d", "c_loss_g"))
  # Both step-2 runs start from the same checkpoint, but cuDNN may pick
  # other algorithms in the second run, and some of its backward kernels
  # sum with atomics, so the two step-2 gradients may differ in summation
  # order.  Losses: 1e-4 relative (float32, TF32 off).  Parameters: at its
  # n-th update Adam (beta1 0.5, beta2 0.999) moves a weight by at most
  # c_n lr, c_2 = 1.054, c_3 = 1.134, c_4 = 1.229 (Cauchy-Schwarz over the
  # gradient history), in a direction that a gradient near 0 may flip.
  # Step 2 is G's 2nd update (lr 1e-4): 2.2 lr; D's 3rd and 4th (lr 4e-4):
  # 4.8 lr.  The EMA takes 1e-3 of G's step.
  g_tol = 2.2 * 1e-4
  tols = {"G": g_tol, "D": 4.8 * 4e-4, "EMA": 1e-3 * g_tol}
  with torch.no_grad():
    worst = {
        "G": max(float((p - q).abs().max()) for p, q in zip(
            got.generator.parameters(), want.generator.parameters())),
        "D": max(float((p - q).abs().max()) for p, q in zip(
            got.discriminator.parameters(),
            want.discriminator.parameters())),
        "EMA": max(float((got.ema_params[k] - v).abs().max())
                   for k, v in want.ema_params.items()),
    }
  identical = worst_loss == 0 and not any(worst.values())
  print(f"phase 5: resume from the step-1 checkpoint, step 2 against the "
        f"uninterrupted run's: max relative loss difference "
        f"{worst_loss:.3e} (tolerance 1e-4); max |param difference| "
        + ", ".join(f"{k} {w:.3e} (tolerance {tols[k]:.1e})"
                    for k, w in worst.items())
        + f"; bit-identical: {identical}", flush=True)
  if worst_loss > 1e-4 or any(w > tols[k] for k, w in worst.items()):
    fail("the resumed step 2 disagrees with the uninterrupted run")


def evaluate_flagship(torch, card, workdir, config, dev):
  """Phase 6: FID/IS of phase 4's checkpoint (trained with ``config``) on
  ``dev``, at full width."""
  import csv

  from xmcgan_image_generation_tpu_torch import evaluate

  print(f"phase 6: evaluate_continuously on phase 4's checkpoint: "
        f"{config.image_size}px G, normal and EMA weights, InceptionV3 at "
        f"299 px (random weights, seed 0), eval_batch_size "
        f"{config.eval_batch_size}; cut: eval_num {config.eval_num} -> "
        f"{EVAL_NUM}, eval_avg_num {config.eval_avg_num} -> {EVAL_AVG_NUM}",
        flush=True)
  config.update(eval_num=EVAL_NUM, eval_avg_num=EVAL_AVG_NUM)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  start = time.perf_counter()
  metric = evaluate.evaluate_continuously(config, workdir, dev, timeout=60)
  total = time.perf_counter() - start
  peak = torch.cuda.max_memory_allocated()
  with open(os.path.join(workdir, "checkpoints", "scores.csv")) as f:
    rows = list(csv.DictReader(f))
  if len(rows) != 1:
    fail(f"scores.csv has {len(rows)} rows, expected 1")
  for key, value in rows[0].items():
    if not math.isfinite(float(value)):
      fail(f"scores.csv: {key} = {value}")
  rate = metric.last_images / metric.last_generate_seconds
  print(f"  real statistics ({EVAL_NUM} images through Inception): "
        f"{metric.real_seconds:.2f} s", flush=True)
  print(f"  generated: {metric.last_images} images (normal and EMA) in "
        f"{metric.last_generate_seconds:.2f} s, sampling plus Inception: "
        f"{rate:.2f} images/s; the checkpoint scored in "
        f"{metric.last_seconds:.2f} s with the host's FID and IS math; "
        f"the service {total:.2f} s in all ({card})", flush=True)
  print(f"  peak device memory: {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated)", flush=True)
  print(f"  scores.csv row: {json.dumps(rows[0])}", flush=True)
  eval_breakdown(torch, config, dev, workdir, metric)


def eval_breakdown(torch, config, dev, workdir, metric):
  """Phase 6b: one batch of the generated pass, part by part, on the
  checkpoint phase 6 scored: drawing and moving the batch (host clock),
  sampling with both weight sets and one Inception call (CUDA events), and
  the host's statistics of one feature batch (host clock, device to host
  copy included).  Inception again with cuDNN allowed TF32, which the
  evaluation does not use, for the size of that lever."""
  from xmcgan_image_generation_tpu_torch.engine.sampling import (
      generate_batch,
  )
  from xmcgan_image_generation_tpu_torch.engine.state import (
      create_train_state,
  )
  from xmcgan_image_generation_tpu_torch.evaluate import eval_stream
  from xmcgan_image_generation_tpu_torch.utils import checkpoint
  from xmcgan_image_generation_tpu_torch.utils import fid
  from xmcgan_image_generation_tpu_torch.utils.bridge import to_tensors

  manager = checkpoint.CheckpointManager(checkpoint.checkpoints_dir(workdir))
  state = manager.restore(manager.latest_step(),
                          create_train_state(config, dev, seed=config.seed))
  stream = eval_stream(config)
  iters = 5

  def host_ms(fn):
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
      fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / iters * 1e3

  draw = host_ms(lambda: to_tensors(next(stream), dev))
  batch = to_tensors(next(stream), dev)
  sample = time_ms(lambda: generate_batch(state, batch, config), iters)
  images = generate_batch(state, batch, config)["generated_image"]
  features = metric._inception  # the service's own feature function
  inception = time_ms(lambda: features(images), iters)
  pool, probs = features(images)
  stats = fid.StreamingGaussianStats(pool.shape[1])
  score = fid.StreamingInceptionScore(probs.shape[1])
  host = host_ms(lambda: (stats.update(pool), score.update(probs)))
  torch.backends.cudnn.allow_tf32 = True
  inception_tf32 = time_ms(lambda: features(images), iters)
  torch.backends.cudnn.allow_tf32 = False
  n = images.shape[0]
  per_batch = draw + sample + 2 * inception + 2 * host
  print(f"phase 6b: one batch of {n} of the generated pass, ms: drawing "
        f"and moving it {draw:.2f}; sampling, normal and EMA weights "
        f"{sample:.2f}; Inception (resize, InceptionV3 at 299 px in float32, "
        f"softmax) {inception:.2f} per weight set ({inception_tf32:.2f} with "
        f"cuDNN TF32); host statistics {host:.2f} per weight set; sum "
        f"{per_batch:.2f} ms = {2 * n / per_batch * 1e3:.2f} images/s "
        f"against phase 6's measured "
        f"{metric.last_images / metric.last_generate_seconds:.2f}",
        flush=True)


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
  print(f"phase 2: built {', '.join(p.name for p in result.paths)} in "
        f"{result.seconds:.1f} s, one nvcc per source in parallel "
        f"({time.perf_counter() - start:.1f} s with loading)", flush=True)
  for line in result.log.splitlines():
    if "ptxas" in line or "spill" in line:
      print(f"  {line.strip()}")

  src = "xmcgan_image_generation_tpu_torch/csrc/"
  pallas = "xmcgan_image_generation_tpu/ops/pallas/"
  records = {
      "ntxent": {"name": "ntxent", "route": "cuda",
                 "source": src + "ntxent.cu",
                 "replaces": pallas + "ntxent.py:51"},
      # The TPU's backward was jnp that XLA fused (nt_xent_fused's _bwd).
      "ntxent_bwd": {"name": "ntxent_bwd", "route": "cuda",
                     "source": src + "ntxent.cu",
                     "replaces": pallas + "ntxent.py:90"},
      "word_scores_fwd": {"name": "word_scores_fwd", "route": "cuda",
                          "source": src + "word_scores.cu",
                          "replaces": pallas + "word_scores.py:44"},
      "word_scores_drn": {"name": "word_scores_drn", "route": "cuda",
                          "source": src + "word_scores.cu",
                          "replaces": pallas + "word_scores.py:185"},
      "word_scores_dwn": {"name": "word_scores_dwn", "route": "cuda",
                          "source": src + "word_scores.cu",
                          "replaces": pallas + "word_scores.py:211"},
  }
  # No single PyTorch call computes any of these functions.
  for rec in records.values():
    rec["library_ms"] = None
  print("phase 3: kernels against their plain versions, flagship shapes",
        flush=True)
  check_kernels(torch, records)
  check_small_step(torch)
  dev = torch.device("cuda")
  config = flagship_config()
  with tempfile.TemporaryDirectory() as workdir:
    train_flagship(torch, records, card, workdir, config)
    check_resume(torch, dev)
    evaluate_flagship(torch, card, workdir, config, dev)

  print(json.dumps({"kernels": list(records.values())}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()

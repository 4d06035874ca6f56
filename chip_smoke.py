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
3c. holds kernels A (forward and backward), B and C against their plain
   versions at the 256 px path's microbatch (I = C = 128; A's variant for
   B > 64), times them and states their bounds;
4. trains the flagship configuration (128 px, 2 x 56 super-batch,
   bfloat16, every contrastive head and the ResNet-50 tower) for a few
   outer steps through ``train.train`` on the synthetic source, through
   the loader's worker processes and the pinned-memory prefetcher, checks
   the losses are finite and that kernels A (forward and backward), B and
   C launched during the steps, and prints the step time beside the input
   stall, images/s, peak device memory and the last step's checkpoint
   save;
4c. trains ``configs/coco_xmc_256.py`` at full width (256 px, 2 x 256,
   bfloat16, remat of the 256 px blocks) through ``train.train`` with
   ``grad_accum_steps=2`` (4 if 2 does not fit, the reason printed) for 2
   warm-up and 3 timed steps, checks the losses are finite and that A, A
   backward, B and C launched k times as often a step as in phase 4, and
   prints the step time, images/s, peak memory and the checkpoint;
4d. one critic update at 256 px on a microbatch of 8 (float32,
   deterministic cuDNN) with remat off, "full" and "conv" from the same
   weights: D's gradients agree and each ``u0`` advanced exactly once;
4b. the real-data path: writes COCO TFRecord shards in the JAX package's
   schema (PNG rows filtered with all five filter types in turn), a
   full-resolution 480 x 640 train split, the same images pre-resized to
   128 px and a small validation split; holds the data loader's host
   helper (``csrc/host/fastio.cpp``: PNG un-filter, Pillow's bilinear
   resize, CRC32C) against its plain numpy version bit for bit; trains
   the flagship configuration from each train layout through
   ``train.train`` (kernels A, B and C checked launched) and prints the
   CPU count, the worker count, the step time, images/s, the input stall,
   the host's ms per example to read, decode and preprocess, and peak
   memory; then scores the full-resolution run's checkpoint against the
   validation records with ``evaluate_continuously`` (small ``eval_num``);
5. trains the test configuration 2 steps, then resumes a fresh run from
   the step-1 checkpoint and checks its step 2 against the first run's;
6. scores phase 4's checkpoint with ``evaluate.evaluate_continuously``
   (the flagship G with normal and EMA weights, the full 299 px
   InceptionV3, ``eval_num`` cut to 2048) and prints the seconds, images
   per second, peak memory and the ``scores.csv`` row;
7. serving: exports phase 4's checkpoint with
   ``utils.serving.export_from_workdir`` (EMA weights, bfloat16, symbolic
   batch, and an int8 artifact), serves both ``.pt2`` files at batch 1, 8
   and 56 on the card from a fresh subprocess that imports ``torch`` and
   nothing of the repository, holds the bfloat16 images against the eager
   EMA G on the same inputs, prints the int8-vs-bf16 deviation, the bytes,
   ms per request and images/s; and holds the ResNet-50 tower's
   antialiased 256 -> 224 resize on the card against the CPU's;
8. data parallelism (``parallel/``): (a) holds kernels B, C and D against
   their plain versions at the shapes the sharded word-score dispatch
   gives them (images x captions a process: 28 x 56 at the flagship over
   2 processes, 64 x 128 at the 256 px microbatch), two calls of C and D
   bit for bit, timed and bounded (records ``sharded_<I>x<C>``: the
   launches of 28 x 56 are those of (b)'s step, with the op check's under
   ``launches_in_op_check``; 64 x 128 runs in no phase, its launches are
   null); (b) spawns two processes on the one card, joined over gloo
   (NCCL refuses two ranks on one device), that take one flagship outer
   step in float32 with deterministic cuDNN on their halves of a fixed 2
   x 56 super-batch, and holds them to the one-process step on the same
   super-batch (losses 1e-4 relative; the gradients of the critic update
   and of the joint update alone, each from the seed's state and read
   from Adam's first moment, within 2e-3 of their norm by network, beside
   the one-process step's own change when z moves by a float32 rounding;
   parameters and buffers within ``tests/test_torch_step.py``'s
   tolerances), checks that
   both replicas' parameters, Adam moments, ``u0``, BatchNorm statistics
   and EMA are bit for bit equal, that A, B and C launched on each
   process, and the sharded word
   scores with both gradients (B, C, D and the word gradient's sum over
   processes) against the one-process op; prints each process's
   collective calls and bytes in the step; (c) starts a world-size-1
   NCCL group and takes one test-config step through the collectives
   against the same step without a group; the kernels are built in the
   parent first;
9. every mode over processes: two processes on the one card, joined over
   gloo, run (a) ``evaluate.evaluate_continuously`` on phase 4's
   checkpoint (``TRAIN_DONE`` lands a heartbeat and a half after the
   first row, so process 0 heartbeats while it polls), (b)
   ``generate.generate`` and (c) ``utils.serving.export_from_workdir``;
   the parent holds (a)'s merged statistics and IS, the same on both
   processes, against one ``EvalMetric`` on the same global batches
   (each process's shard concatenated process-major), (b)'s grids against
   one process's of the same global batch, and (c)'s one artifact, served
   from a torch-only process, against phase 7's; checks that process 1
   appended no score and wrote no grid or artifact; prints each process's
   scoring seconds, host-statistics ms a batch and control-plane counts
   beside phase 6's one process.  None of kernels A-D is on these paths;
10. prints the kernel records as one JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Each phase prints its seconds.  Any failed phase exits non-zero before
the last line.  Without a CUDA device, or outside a checkout, it exits
non-zero at once.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import subprocess
import sys
import tempfile
import time

WARMUP_STEPS = 2
TIMED_STEPS = 5
TIMED_STEPS_256 = 3      # the 256 px phase's timed steps
MICROBATCH_256 = 128     # the 256 px path's microbatch at grad_accum_steps=2
KERNEL_ITERS = 20
EVAL_NUM = 2048          # of the configuration's 30000, to fit the limit
EVAL_AVG_NUM = 1         # of 3
RECORDS_TRAIN = 112      # one super-batch of distinct records a layout
RECORDS_VAL = 112
RECORDS_EVAL_NUM = 224   # the real-data phase's eval_num
FULL_SIZE = (480, 640)   # COCO's common image size
HOST_SAMPLE = 24         # records timed one by one on the host
SERVE_BATCHES = (1, 8, 56)
SERVE_STEPS = 10         # calls a timing window
SERVE_WINDOWS = 5
# The artifact runs G's own operations on the same card, so its bf16
# images are expected bit for bit; the check allows 2^-5 (eight bf16 ulps
# of the top binade of [0, 1]) for cuDNN picking other algorithms in the
# serving process.
SERVE_ATOL = 2.0 ** -5

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


def loss_lines(workdir):
  """The lines of ``workdir/metrics.jsonl`` that hold the losses (the
  others hold ``steps_per_sec``)."""
  with open(os.path.join(workdir, "metrics.jsonl")) as f:
    lines = [json.loads(line) for line in f]
  return [line for line in lines if "d_loss" in line]


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


def word_scores_bounds(records, n, regions, words, dim, saved_bytes,
                       captions=None):
  """Bytes and operations of kernels B, C and D at these shapes (float32,
  n images and n captions, or ``captions`` captions).  B forms S = rn
  wn^T, the Gram matrix rn rn^T and G alpha; reads rn, wn and the mask;
  writes the scores and the record.  C forms E wn, H = alpha diag(b)
  alpha^T and H rn; reads rn, wn, the mask, g and the record; writes d_rn.
  D forms E^T rn; reads rn, the mask, g and the record; writes d_wn.  All
  three take the 3xTF32 route.  Returns each kernel's bytes-bound and
  float32-FMA-bound ms."""
  c = n if captions is None else captions
  rn, wn = 4 * n * regions * dim, 4 * c * words * dim
  mask, scores = 4 * c * words, 4 * n * c       # g is the size of scores
  sim = 2 * n * c * regions * words * dim       # one [R, L, D] product per pair
  gram = 2 * n * regions * regions * dim
  g_alpha = 2 * n * c * words * regions * regions
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
      losses[use_pallas] = loss_lines(workdir)[0]
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


def check_kernels_microbatch(torch, records, batch):
  """Phase 3c: kernels A (forward and backward), B and C against their
  plain versions at the 256 px path's microbatch (I = C = ``batch``; A's
  variant for B > 64), timed as at the flagship shapes, with their
  bounds; kept in each record under ``at_batch_<batch>``."""
  from xmcgan_image_generation_tpu_torch.ops.attention import padding_mask
  from xmcgan_image_generation_tpu_torch.ops.contrastive import l2_normalize
  from xmcgan_image_generation_tpu_torch.ops.cuda import ntxent
  from xmcgan_image_generation_tpu_torch.ops.cuda import word_scores as ws

  dev = torch.device("cuda")
  gen = torch.Generator(device=dev).manual_seed(1)
  pool_dim, regions, words, dim = 1536, 256, 17, 768
  g1 = g2 = 5.0
  out = {name: {} for name in ("ntxent", "ntxent_bwd", "word_scores_fwd",
                               "word_scores_drn")}

  def check(name, label, err, tol):
    print(f"  {name} [{label}], I = C = {batch}: max|kernel - plain| = "
          f"{err:.3e} (tolerance {tol:.1e}) {'ok' if err <= tol else 'FAIL'}",
          flush=True)
    if err > tol:
      fail(f"{name} [{label}] disagrees with its plain version at {batch}")

  g_out = torch.tensor([1.7, 0.3, 0.2], device=dev)
  for dtype in (torch.float32, torch.bfloat16):
    a = torch.randn(batch, pool_dim, device=dev, generator=gen).abs()
    b = torch.randn(batch, pool_dim, device=dev, generator=gen)
    a, b = a.to(dtype), b.to(dtype)
    record = torch.empty(ntxent.record_floats(batch), device=dev)
    err = float((ntxent.ntxent_stats(a, b, 0.1, record)
                 - ntxent.ntxent_plain(a, b, 0.1)).abs().max())
    check("ntxent", str(dtype), err, 2e-4)
    d_got = ntxent.ntxent_bwd(a, b, record, g_out, 0.1)
    d_want = ntxent.ntxent_bwd_plain(a, b, g_out[0], 0.1)
    d_err = max(float((x.float() - y.float()).abs().max())
                for x, y in zip(d_got, d_want))
    scale = max(float(y.float().abs().max()) for y in d_want)
    # As at the flagship shapes: f32 summation order; bf16 one ulp.
    check("ntxent_bwd", str(dtype), d_err,
          (1e-4 if dtype == torch.float32 else 8e-3) * scale)
    if dtype == torch.float32:
      out["ntxent"]["max_abs_err"] = err
      out["ntxent_bwd"]["max_abs_err"] = d_err
  out["ntxent"]["ms"] = time_ms(lambda: ntxent.ntxent_stats(a, b, 0.1,
                                                            record))
  out["ntxent"]["plain_ms"] = time_ms(lambda: ntxent.ntxent_plain(a, b, 0.1))
  out["ntxent_bwd"]["ms"] = time_ms(
      lambda: ntxent.ntxent_bwd(a, b, record, g_out, 0.1))
  out["ntxent_bwd"]["plain_ms"] = time_ms(
      lambda: ntxent.ntxent_bwd_plain(a, b, g_out[0], 0.1))
  record_bytes = 4 * ntxent.record_floats(batch)
  set_bound(out["ntxent"], 2 * 2 * batch * pool_dim + 12 + record_bytes,
            2 * batch * batch * pool_dim + 6 * batch * pool_dim, "bfloat16")
  set_bound(out["ntxent_bwd"], 4 * 2 * batch * pool_dim + record_bytes + 4,
            4 * batch * batch * pool_dim + 8 * batch * pool_dim, "bfloat16")

  max_len = torch.randint(3, words + 1, (batch, 1), device=dev,
                          generator=gen)
  mask = padding_mask(max_len.float(), words).contiguous()
  word = torch.randn(batch, words, dim, device=dev, generator=gen)
  wn = l2_normalize(word).contiguous()
  g = torch.randn(batch, batch, device=dev, generator=gen)
  for kind in ("random", "peaked"):
    if kind == "random":
      region = torch.randn(batch, regions, dim, device=dev, generator=gen)
    else:
      pick = (torch.rand(batch, regions, device=dev, generator=gen)
              * max_len).long()
      region = 3 * torch.gather(word, 1, pick[..., None].expand(
          -1, -1, dim)) + 0.5 * torch.randn(batch, regions, dim, device=dev,
                                            generator=gen)
    rn = l2_normalize(region).contiguous()
    saved = ws.new_saved(rn, wn)
    err = float((ws.scores(rn, wn, mask, g1, g2, saved)
                 - ws.scores_plain(rn, wn, mask, g1, g2)).abs().max())
    check("word_scores_fwd", f"{kind}, float32", err, 1e-4)
    d_got = ws.drn(rn, wn, mask, g, saved, g1, g2)
    d_again = ws.drn(rn, wn, mask, g, saved, g1, g2)
    d_want = ws.drn_plain(rn, wn, mask, g, g1, g2)
    d_err = float((d_got - d_want).abs().max())
    check("word_scores_drn", f"{kind}, float32", d_err,
          1e-4 * float(d_want.abs().max()))
    if not torch.equal(d_got, d_again):
      fail(f"two word_scores_drn calls differ at I = C = {batch}")
    for name, e in (("word_scores_fwd", err), ("word_scores_drn", d_err)):
      out[name]["max_abs_err"] = max(out[name].get("max_abs_err", 0.0), e)
  x = rn.clone().requires_grad_()
  s_plain = ws.scores_plain(x, wn, mask, g1, g2)
  out["word_scores_fwd"]["ms"] = time_ms(
      lambda: ws.scores(rn, wn, mask, g1, g2, saved))
  out["word_scores_fwd"]["plain_ms"] = time_ms(
      lambda: ws.scores_plain(rn, wn, mask, g1, g2))
  out["word_scores_drn"]["ms"] = time_ms(
      lambda: ws.drn(rn, wn, mask, g, saved, g1, g2))
  out["word_scores_drn"]["plain_ms"] = time_ms(
      lambda: torch.autograd.grad(s_plain, x, g.t(), retain_graph=True))
  del s_plain, x
  bounds = {"word_scores_fwd": out["word_scores_fwd"],
            "word_scores_drn": out["word_scores_drn"],
            "word_scores_dwn": {}}
  word_scores_bounds(bounds, batch, regions, words, dim,
                     saved.numel() * saved.element_size())
  for name, rec in out.items():
    rec["library_ms"] = None
    records[name][f"at_batch_{batch}"] = rec
    print(f"  {name}, I = C = {batch}: kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})", flush=True)


def config_256(k):
  from xmcgan_image_generation_tpu_torch.configs import coco_xmc_256

  config = coco_xmc_256.get_config()
  config.update(data_source="synthetic",
                num_train_steps=WARMUP_STEPS + TIMED_STEPS_256,
                log_loss_every_steps=1, grad_accum_steps=k,
                grain_worker_count=min(config.grain_worker_count,
                                       os.cpu_count() or 1))
  return config


def train_256(torch, records, card, flagship_steps):
  """Phase 4c: ``configs/coco_xmc_256.py`` at full width through
  train.train, with gradient accumulation over microbatches of 128 (of
  64 when that does not fit) and the configuration's remat."""
  import gc

  from xmcgan_image_generation_tpu_torch import train as train_lib
  from xmcgan_image_generation_tpu_torch.ops.cuda import ntxent
  from xmcgan_image_generation_tpu_torch.ops.cuda import word_scores as ws

  counters = {"ntxent": ntxent.ntxent_stats, "ntxent_bwd": ntxent.ntxent_bwd,
              "word_scores_fwd": ws.scores, "word_scores_drn": ws.drn}
  for k in (2, 4):
    config = config_256(k)
    images_per_step = config.batch_size * config.d_step_per_g_step
    print(f"phase 4c: train.train, configs/coco_xmc_256.py: "
          f"{config.image_size}px, {config.d_step_per_g_step} x "
          f"{config.batch_size}, grad_accum_steps={k} (microbatch "
          f"{config.batch_size // k}), remat={config.remat} (min resolution "
          f"{config.remat_min_resolution}, policy {config.remat_policy}), "
          f"gf_dim={config.gf_dim}, df_dim={config.df_dim}, {config.dtype}, "
          f"pretrained tower={config.pretrained_image_contrastive}, "
          f"{config.num_train_steps} steps, synthetic source (64 examples, "
          f"repeated within a super-batch of {images_per_step})", flush=True)
    oom = None
    with tempfile.TemporaryDirectory() as workdir:
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      for fn in counters.values():
        fn.launches = 0
      try:
        train_lib.train(config, workdir, torch.device("cuda"))
      except torch.cuda.OutOfMemoryError as e:
        oom = str(e).splitlines()[0]
      if oom is None:
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        lines = loss_lines(workdir)
        with open(os.path.join(workdir, "checkpoints.jsonl")) as f:
          saves = [json.loads(line) for line in f]
    if oom is None:
      break
    gc.collect()
    torch.cuda.empty_cache()
    if k == 4:
      fail(f"the 256 px step does not fit at grad_accum_steps=4: {oom}")
    print(f"  grad_accum_steps={k} does not fit on this card ({oom}); "
          f"trying 4", flush=True)
  for line in lines:
    print(f"  {json.dumps(line)}", flush=True)
  if len(lines) != config.num_train_steps:
    fail(f"256 px: {len(lines)} metric lines for {config.num_train_steps} "
         f"steps")
  for line in lines:
    for key, value in line.items():
      if not math.isfinite(value):
        fail(f"256 px, step {line['step']}: {key} = {value}")
  for name, count in launches.items():
    per_step = records[name]["launches"] / flagship_steps
    want = per_step * k * config.num_train_steps
    print(f"  launches during the steps: {name} = {count} (the flagship's "
          f"{per_step:g} a step x {k} microbatches x "
          f"{config.num_train_steps} steps = {want:g})", flush=True)
    if count != want:
      fail(f"256 px: kernel {name} launched {count} times, expected {want}")
    records[name]["launches_by_path"]["coco_xmc_256"] = count
  step_summary(lines, images_per_step, card)
  print(f"  peak device memory: {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated), grad_accum_steps={k}",
        flush=True)
  print(f"  checkpoint at step {saves[-1]['step']}: {saves[-1]['seconds']:.2f}"
        f" s, {saves[-1]['bytes']} bytes ({saves[-1]['bytes'] / 1e9:.3f} GB) "
        f"({card})", flush=True)


def check_remat(torch, card):
  """Phase 4d: one critic (D) update at 256 px, full width, on a
  microbatch of 8 in float32, with remat off, "full" and "conv" from the
  same weights: D's gradients agree, and each ``u0`` advanced once."""
  from xmcgan_image_generation_tpu_torch.configs import coco_xmc_256
  from xmcgan_image_generation_tpu_torch.data import synthetic
  from xmcgan_image_generation_tpu_torch.engine import xmc_gan
  from xmcgan_image_generation_tpu_torch.engine.state import (
      TrainState,
      create_optimizers,
  )
  from xmcgan_image_generation_tpu_torch.models import xmc_net
  from xmcgan_image_generation_tpu_torch.ops.spectral_norm import (
      power_iteration_normalize,
  )

  import numpy as np

  dev = torch.device("cuda")
  base = coco_xmc_256.get_config()
  base.update(dtype="float32", batch_size=8)
  batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic.super_batch(
      base, np.random.default_rng(0), n=8).items()}
  g_rng, d_rng = torch.Generator().manual_seed(0), torch.Generator()
  g_net = xmc_net.Generator(base, device=dev, generator=g_rng)
  d_net = xmc_net.Discriminator(base, device=dev,
                                generator=d_rng.manual_seed(1))
  weights = (g_net.state_dict(), d_net.state_dict())
  layers = {name: m for name, m in d_net.named_modules()
            if getattr(m, "spectral", False)}
  with torch.no_grad():
    once, twice = {}, {}
    for name, m in layers.items():
      _, u1 = power_iteration_normalize(m._kernel_2d(), m.u0)
      _, u2 = power_iteration_normalize(m._kernel_2d(), u1)
      once[name], twice[name] = u1, u2
  results = {}
  # Deterministic cuDNN algorithms, so that the three updates may differ
  # only by what remat changes.
  torch.backends.cudnn.deterministic = True
  for label, remat in (("off", None), ("full", "full"), ("conv", "conv")):
    config = type(base)(base)
    config.update(remat=remat is not None,
                  remat_min_resolution=config.image_size,
                  remat_policy=remat or "full")
    nets = []
    for cls, sd in zip((xmc_net.Generator, xmc_net.Discriminator), weights):
      net = cls(config, device="meta").to_empty(device=dev)
      net.load_state_dict(sd)
      nets.append(net)
    g_opt, d_opt = create_optimizers(config, *nets)
    state = TrainState(step=0, generator=nets[0], discriminator=nets[1],
                       g_opt=g_opt, d_opt=d_opt, ema_params={})
    marked = [n for n, m in nets[1].named_children()
              if getattr(m, "remat_policy", None)]
    xmc_gan.train_d(state, batch, config)
    torch.cuda.synchronize()
    grads = {n: d_opt.state[p]["exp_avg"] / (1 - config.beta1)
             for n, p in nets[1].named_parameters()}
    u0 = {n: dict(nets[1].named_modules())[n].u0.clone() for n in layers}
    results[label] = (grads, u0, marked)
  torch.backends.cudnn.deterministic = False
  ref_grads = results["off"][0]
  top = max(float(g.abs().max()) for g in ref_grads.values())
  ok = True
  for label in ("off", "full", "conv"):
    grads, u0, marked = results[label]
    err_once = max(float((u0[n] - once[n]).abs().max()) for n in layers)
    # Layers whose second power step moves u (a one-feature layer's u is
    # +-1 after any step): u0 must not be the twice-advanced one there.
    err_twice = min(float((u0[n] - twice[n]).abs().max()) for n in layers
                    if float((once[n] - twice[n]).abs().max()) > 1e-3)
    worst, worst_name = 0.0, None
    identical = all(torch.equal(g, ref_grads[n]) for n, g in grads.items())
    # float32, TF32 off, deterministic cuDNN: the recompute runs the same
    # convolutions on the same inputs; 1e-4 of each tensor's largest
    # gradient, and 1e-6 of D's, for a summation order that may differ.
    for n, g in grads.items():
      ref = ref_grads[n]
      tol = 1e-4 * float(ref.abs().max()) + 1e-6 * top
      err = float((g - ref).abs().max()) / tol
      if err > worst:
        worst, worst_name = err, n
    print(f"  remat {label}: blocks recomputed {marked or 'none'}; D "
          f"gradient against remat off: bit-identical {identical}, worst "
          f"max|difference| / tolerance = {worst:.3f} ({worst_name}); "
          f"u0: max|u0 - one power step| {err_once:.3e} "
          f"(tolerance 1e-5), least max|u0 - two steps| {err_twice:.3e} "
          f"(over the layers a second step moves by more than 1e-3)",
          flush=True)
    ok = ok and worst <= 1.0 and err_once <= 1e-5 and err_twice > 1e-5
    if label != "off" and marked != ["DiscOptimizedBlock_0"]:
      fail(f"remat {label} recomputed {marked}, expected "
           f"DiscOptimizedBlock_0 alone")
  if not ok:
    fail("remat changed D's gradient or advanced u0 other than once")


def flagship_config():
  from xmcgan_image_generation_tpu_torch.configs import coco_xmc

  config = coco_xmc.get_config()
  config.data_source = "synthetic"
  config.num_train_steps = WARMUP_STEPS + TIMED_STEPS
  # A metrics line a step, each step timed to the device's end.
  config.log_loss_every_steps = 1
  config.grain_worker_count = min(config.grain_worker_count,
                                  os.cpu_count() or 1)
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
        f"{config.num_train_steps} steps, synthetic source, "
        f"{config.grain_worker_count} loader workers, "
        f"{config.prefetch_batches} batches prefetched", flush=True)
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
    records[name]["launches_by_path"] = {"flagship_128": fn.launches}
  peak = torch.cuda.max_memory_allocated()
  lines = loss_lines(workdir)
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
  step_summary(lines, images_per_step, card)
  print(f"  peak device memory: {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated)", flush=True)
  if [save["step"] for save in saves] != [config.num_train_steps]:
    fail(f"checkpoints saved at steps {[s['step'] for s in saves]}, "
         f"expected the last step only")
  print(f"  checkpoint at step {saves[0]['step']} (outside the timed "
        f"steps): {saves[0]['seconds']:.2f} s, {saves[0]['bytes']} bytes "
        f"({saves[0]['bytes'] / 1e9:.3f} GB) ({card})", flush=True)


def step_summary(lines, images_per_step, card):
  """Prints the step time and the input stall over the timed steps."""
  secs = sorted(line["seconds"] for line in lines[WARMUP_STEPS:])
  mean = sum(secs) / len(secs)
  stall = [line["data_seconds"] for line in lines[WARMUP_STEPS:]]
  print(f"  step time over {len(secs)} steps after {WARMUP_STEPS} warm-up "
        f"(from asking the prefetcher for the super-batch to the step's end "
        f"on the card): mean {mean * 1e3:.2f} ms, min {secs[0] * 1e3:.2f} "
        f"ms, max {secs[-1] * 1e3:.2f} ms; input stall (blocked waiting for "
        f"the batch) mean {sum(stall) / len(stall) * 1e3:.2f} ms, max "
        f"{max(stall) * 1e3:.2f} ms a step ({card})", flush=True)
  print(f"  throughput: {images_per_step / mean:.2f} img/s "
        f"({images_per_step} images per outer step)", flush=True)


def encode_png_filtered(image):
  """An 8-bit RGB PNG whose rows use the filter types 0-4 in turn (a
  helper of this script, not of the package)."""
  import struct
  import zlib

  import numpy as np

  def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))

  h, w, ch = image.shape
  x = image.reshape(h, w * ch).astype(np.int32)
  rows = []
  for y in range(h):
    kind = y % 5
    cur = x[y]
    up = x[y - 1] if y else np.zeros_like(cur)
    left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
    upleft = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
    pred = (0, left, up, (left + up) >> 1, paeth(left, up, upleft))[kind]
    rows.append(bytes([kind]) + ((cur - pred) & 255).astype(np.uint8)
                .tobytes())

  def chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))

  return (b"\x89PNG\r\n\x1a\n"
          + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
          + chunk(b"IDAT", zlib.compress(b"".join(rows)))
          + chunk(b"IEND", b""))


def fabricate_image(seed):
  """One full-resolution image (smooth low-frequency content plus noise,
  as natural images) and its PNGs at full size and pre-resized to 128 px,
  as ``tools/preprocess_coco.py --store_size 128`` stores it."""
  import numpy as np

  from xmcgan_image_generation_tpu_torch.data import resize

  rng = np.random.default_rng(seed)
  h, w = FULL_SIZE
  small = rng.integers(0, 256, (h // 16, w // 16, 3), np.uint8)
  image = resize.resize_uint8(small, h, w).astype(np.int16)
  image = np.clip(image + np.rint(rng.normal(0, 2, image.shape)), 0,
                  255).astype(np.uint8)
  return (encode_png_filtered(image),
          encode_png_filtered(resize.resize_uint8(image, 128, 128)))


def write_record_layouts(root):
  """Train shards at full resolution (``full/``) and pre-resized to 128 px
  (``pre_resized/``), each beside the same small validation split (128
  px); four shards a train split.  Returns the two directories and the
  first record's full-resolution PNG."""
  import concurrent.futures
  import multiprocessing

  import numpy as np

  from xmcgan_image_generation_tpu_torch.data import native
  from xmcgan_image_generation_tpu_torch.data import records

  start = time.perf_counter()
  native.library()   # built once here, before the processes load it
  print(f"  host helper built and loaded in {time.perf_counter() - start:.1f}"
        f" s ({native.find_compiler()})", flush=True)
  start = time.perf_counter()
  ctx = multiprocessing.get_context("spawn")
  with concurrent.futures.ProcessPoolExecutor(
      max_workers=os.cpu_count() or 1, mp_context=ctx) as pool:
    pngs = list(pool.map(fabricate_image,
                         range(RECORDS_TRAIN + RECORDS_VAL)))
  rng = np.random.default_rng(0)
  dirs = {name: os.path.join(root, name) for name in ("full", "pre_resized")}
  sizes = {}
  for layout, directory in dirs.items():
    os.makedirs(directory)
    for split, first, count, shards in (
        ("train", 0, RECORDS_TRAIN, 4),
        ("validation", RECORDS_TRAIN, RECORDS_VAL, 1)):
      writers = [records.TFRecordWriter(os.path.join(
          directory, f"coco2014_{split}.tfrecord-{i:05d}-of-{shards:05d}"))
          for i in range(shards)]
      for n in range(count):
        full, small = pngs[first + n]
        image = full if layout == "full" and split == "train" else small
        sizes.setdefault((layout, split), []).append(len(image))
        writers[n % shards].write(records.build_example({
            "image": image,
            "image/filename": [f"{split}_{n:06d}.png".encode()],
            "caption/embedding": rng.standard_normal(
                5 * 17 * 768).astype(np.float32),
            "caption/max_len": rng.integers(3, 18, (5,)).astype(np.int64),
            "caption/text": [f"caption {n} {c}".encode() for c in range(5)],
        }))
      for w in writers:
        w.close()
  print(f"  wrote {RECORDS_TRAIN} train records in each layout and "
        f"{RECORDS_VAL} validation records (128 px) in "
        f"{time.perf_counter() - start:.1f} s; mean PNG bytes: full "
        f"resolution {np.mean(sizes[('full', 'train')]):.0f}, pre-resized "
        f"{np.mean(sizes[('pre_resized', 'train')]):.0f}", flush=True)
  return dirs, pngs[0][0]


def check_host_helper(full_png):
  """The host helper against its plain numpy versions, bit for bit."""
  import numpy as np

  from xmcgan_image_generation_tpu_torch.data import png
  from xmcgan_image_generation_tpu_torch.data import records
  from xmcgan_image_generation_tpu_torch.data import resize

  checks = {}
  image = png.decode(full_png)
  checks["PNG decode, 480 x 640, five filter types"] = np.array_equal(
      image, png.decode(full_png, plain=True))
  small = resize.resize_uint8(image, 128, 128)
  checks["resize 480 x 640 -> 128 x 128"] = np.array_equal(
      small, resize.resize_uint8_plain(image, 128, 128))
  checks["zoom_crop resize 128 -> 144"] = np.array_equal(
      resize.resize_uint8(small, 144, 144),
      resize.resize_uint8_plain(small, 144, 144))
  checks["CRC32C of the PNG"] = (records.crc32c(full_png[:200_000])
                                 == records.crc32c_plain(full_png[:200_000]))
  for name, ok in checks.items():
    print(f"  host helper against its plain version, {name}: "
          f"{'bit-identical' if ok else 'DIFFERS'}", flush=True)
    if not ok:
      fail(f"host helper: {name} differs from its plain version")


def host_ms_per_example(config):
  """One core's ms per example, in this process: read (pread and parse
  the record), decode (the PNG) and preprocess (the loader's transform
  less its decode: resize, flip, augment, caption, z)."""
  import numpy as np

  from xmcgan_image_generation_tpu_torch.data import pipeline
  from xmcgan_image_generation_tpu_torch.data import png

  loader = pipeline.create_datasets(config, seed=config.seed)[0]
  read = decode = transform = 0.0
  for i in range(HOST_SAMPLE):
    t0 = time.perf_counter()
    features = loader.source[i % len(loader.source)]
    t1 = time.perf_counter()
    png.decode(features["image"])
    t2 = time.perf_counter()
    loader.transform(features, np.random.default_rng(i))
    t3 = time.perf_counter()
    read, decode, transform = read + t1 - t0, decode + t2 - t1, transform + (
        t3 - t2)
  n = HOST_SAMPLE / 1e3
  return read / n, decode / n, (transform - decode) / n


def train_from_records(torch, card, config, label, workdir):
  """Trains ``config`` (its records in ``config.data_dir``) in
  ``workdir`` through train.train; checks the losses and that kernels A,
  B and C launched; prints the step time, stall and host costs."""
  from xmcgan_image_generation_tpu_torch import train as train_lib
  from xmcgan_image_generation_tpu_torch.ops.cuda import ntxent
  from xmcgan_image_generation_tpu_torch.ops.cuda import word_scores as ws

  images_per_step = config.batch_size * config.d_step_per_g_step
  read, decode, prep = host_ms_per_example(config)
  print(f"  {label}: os.cpu_count() = {os.cpu_count()}, "
        f"{config.grain_worker_count} loader workers, "
        f"{config.prefetch_batches} batches prefetched; host ms per "
        f"example on one core: read {read:.2f}, decode {decode:.2f}, "
        f"preprocess {prep:.2f} (sum {read + decode + prep:.2f}: "
        f"{(read + decode + prep) * images_per_step / 1e3:.2f} core-seconds "
        f"a super-batch of {images_per_step})", flush=True)
  counters = {"ntxent": ntxent.ntxent_stats, "ntxent_bwd": ntxent.ntxent_bwd,
              "word_scores_fwd": ws.scores, "word_scores_drn": ws.drn}
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  for fn in counters.values():
    fn.launches = 0
  train_lib.train(config, workdir, torch.device("cuda"))
  launches = {name: fn.launches for name, fn in counters.items()}
  peak = torch.cuda.max_memory_allocated()
  lines = loss_lines(workdir)
  if len(lines) != config.num_train_steps:
    fail(f"{label}: {len(lines)} metric lines for {config.num_train_steps} "
         f"steps")
  for line in lines:
    for key, value in line.items():
      if not math.isfinite(value):
        fail(f"{label}, step {line['step']}: {key} = {value}")
  print(f"  {label}: launches during the steps {json.dumps(launches)}",
        flush=True)
  for name, count in launches.items():
    if count <= 0:
      fail(f"{label}: kernel {name} was not launched by the training steps")
  step_summary(lines, images_per_step, card)
  print(f"  peak device memory: {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated)", flush=True)


def real_data_phase(torch, card, dev):
  """Phase 4b: the flagship configuration trained from COCO records in
  both layouts, and scored against the validation records."""
  import csv

  from xmcgan_image_generation_tpu_torch import evaluate

  print("phase 4b: the real-data path (TFRecords, PNG decode and resize on "
        "the host, loader workers, pinned-memory prefetcher)", flush=True)
  with tempfile.TemporaryDirectory() as root:
    dirs, full_png = write_record_layouts(root)
    check_host_helper(full_png)
    workdirs = {}
    for layout in ("full", "pre_resized"):
      config = flagship_config()
      config.update(data_source="tfrecord", data_dir=dirs[layout],
                    coco_version="2014", eval_every_steps=10**9)
      workdirs[layout] = os.path.join(root, f"work_{layout}")
      size = ("480 x 640 PNGs" if layout == "full"
              else "128 px PNGs (pre-resized)")
      train_from_records(torch, card, config, f"{layout} ({size})",
                         workdirs[layout])
    config.update(data_dir=dirs["full"], eval_num=RECORDS_EVAL_NUM,
                  eval_avg_num=1)
    t0 = time.perf_counter()
    metric = evaluate.evaluate_continuously(config, workdirs["full"], dev,
                                            timeout=60)
    with open(os.path.join(workdirs["full"], "checkpoints",
                           "scores.csv")) as f:
      rows = list(csv.DictReader(f))
    if len(rows) != 1 or not all(math.isfinite(float(v))
                                 for v in rows[0].values()):
      fail(f"real-data evaluation: scores.csv rows {rows}")
    print(f"  evaluate_continuously on the full-resolution run's checkpoint "
          f"against the validation records: eval_num {RECORDS_EVAL_NUM}, "
          f"{metric.last_images} generated images, "
          f"{time.perf_counter() - t0:.2f} s; scores.csv row "
          f"{json.dumps(rows[0])}", flush=True)


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
      losses.append(loss_lines(workdir)[-1])
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
  print(f"  host statistics (device synchronized first, the copy to the "
        f"host included): "
        f"{metric.last_host_seconds / metric.last_host_batches * 1e3:.2f} "
        f"ms a batch of {config.eval_batch_size} and weight set "
        f"({metric.last_host_batches} batches)", flush=True)
  eval_breakdown(torch, config, dev, workdir, metric)
  return metric


def eval_breakdown(torch, config, dev, workdir, metric):
  """Phase 6b: one batch of the generated pass, part by part, on the
  checkpoint phase 6 scored: taking the batch from the prefetcher (host
  clock: the wait when the loader's workers fall behind),
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

  manager = checkpoint.CheckpointManager(checkpoint.checkpoints_dir(workdir))
  state = manager.restore(manager.latest_step(),
                          create_train_state(config, dev, seed=config.seed))
  stream = eval_stream(config, dev)
  iters = 5

  def host_ms(fn):
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
      fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / iters * 1e3

  draw = host_ms(lambda: next(stream))
  batch = next(stream)
  stream.close()
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
  print(f"phase 6b: one batch of {n} of the generated pass, ms: taking "
        f"it from the prefetcher {draw:.2f}; sampling, normal and EMA weights "
        f"{sample:.2f}; Inception (resize, InceptionV3 at 299 px in float32, "
        f"softmax) {inception:.2f} per weight set ({inception_tf32:.2f} with "
        f"cuDNN TF32); host statistics {host:.2f} per weight set; sum "
        f"{per_batch:.2f} ms = {2 * n / per_batch * 1e3:.2f} images/s "
        f"against phase 6's measured "
        f"{metric.last_images / metric.last_generate_seconds:.2f}",
        flush=True)


# The serving process: it imports torch and nothing of the repository (nor
# JAX), loads each artifact (waiting for one still to be written), serves
# every batch of the inputs file and times SERVE_WINDOWS windows of
# SERVE_STEPS calls with CUDA events.
_SERVE_SCRIPT = """
import json, os, sys, time
BLOCKED = ("jax", "jaxlib", "flax", "xmcgan_image_generation_tpu",
           "xmcgan_image_generation_tpu_torch")
for name in BLOCKED:
  sys.modules[name] = None
import torch
inputs_path, out_path, steps, windows, *artifacts = sys.argv[1:]
if not all(os.path.exists(p[:-len(".pt2")] + ".json") for p in artifacts):
  # An artifact still to be written: start the card, then wait for its
  # sidecar, written after it.
  torch.zeros(1, device="cuda")
  while not all(os.path.exists(p[:-len(".pt2")] + ".json")
                for p in artifacts):
    time.sleep(0.1)
inputs = torch.load(inputs_path)
report, images = {}, {}
for path in artifacts:
  t0 = time.perf_counter()
  module = torch.export.load(path).module()
  entry = {"load_seconds": time.perf_counter() - t0, "batches": {}}
  with torch.no_grad():
    for b, x in inputs.items():
      t0 = time.perf_counter()
      images[(path, b)] = module(*x)
      torch.cuda.synchronize()
      first = time.perf_counter() - t0
      ms = []
      for _ in range(int(windows)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(int(steps)):
          module(*x)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / int(steps))
      entry["batches"][b] = {"first_call_seconds": first, "ms_windows": ms}
  report[path] = entry
torch.save(images, out_path)
report["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED
                          and sys.modules[m] is not None)
print(json.dumps(report))
"""


def serve_flagship(torch, card, workdir, config, dev):
  """Phase 7: phase 4's checkpoint exported and served from a torch-only
  process, against the eager EMA G; the tower's resize on the card."""
  import statistics

  from torch.func import functional_call

  from xmcgan_image_generation_tpu_torch.engine.state import (
      create_train_state,
  )
  from xmcgan_image_generation_tpu_torch.utils import checkpoint
  from xmcgan_image_generation_tpu_torch.utils import pretrained
  from xmcgan_image_generation_tpu_torch.utils import serving

  print(f"phase 7: serving: export of phase 4's checkpoint "
        f"({config.image_size}px G, EMA weights, {config.dtype}, symbolic "
        f"batch; and int8), served at batches {list(SERVE_BATCHES)} from a "
        f"torch-only process", flush=True)
  paths = {}
  for name, quantize in (("bf16", None), ("int8", "int8")):
    t0 = time.perf_counter()
    (paths[name],) = serving.export_from_workdir(config, workdir, device=dev,
                                                 quantize=quantize)
    print(f"  {name}: export_from_workdir (restore, export, save) "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{os.path.getsize(paths[name])} bytes ({card})", flush=True)
  rng = torch.Generator().manual_seed(7)
  inputs = {b: [x.to(dev) for x in (
      torch.randn(b, serving.BERT_DIM, generator=rng),
      torch.randn(b, serving.COCO_MAX_TEXT_LENGTH, serving.BERT_DIM,
                  generator=rng),
      torch.randint(3, serving.COCO_MAX_TEXT_LENGTH + 1, (b, 1),
                    generator=rng).float(),
      torch.randn(b, config.z_dim, generator=rng))] for b in SERVE_BATCHES}
  inputs_path = os.path.join(workdir, "serving", "inputs.pt")
  out_path = os.path.join(workdir, "serving", "images.pt")
  torch.save(inputs, inputs_path)
  t0 = time.perf_counter()
  proc = subprocess.run(
      [sys.executable, "-c", _SERVE_SCRIPT, inputs_path, out_path,
       str(SERVE_STEPS), str(SERVE_WINDOWS), paths["bf16"], paths["int8"]],
      capture_output=True, text=True, timeout=600, cwd=workdir, check=False)
  if proc.returncode != 0:
    fail(f"the serving process: {proc.stderr[-3000:]}")
  report = json.loads(proc.stdout.strip().splitlines()[-1])
  print(f"  serving process: {time.perf_counter() - t0:.2f} s in all "
        f"(start, imports, loads, serving); modules of the repository or "
        f"JAX loaded there: {report['loaded']}", flush=True)
  if report["loaded"]:
    fail(f"the serving process imported {report['loaded']}")
  served = torch.load(out_path)

  manager = checkpoint.CheckpointManager(checkpoint.checkpoints_dir(workdir))
  state = manager.restore(manager.latest_step(),
                          create_train_state(config, dev, seed=config.seed))
  g = state.generator.eval()
  dtype = g.dtype

  def eager(x):
    cond = dict(zip(("sentence_embedding", "embedding", "max_len"),
                    (v.to(dtype) for v in x[:3])))
    return functional_call(g, state.ema_params, (cond, x[3].to(dtype)))

  for b, x in inputs.items():
    with torch.no_grad():
      want = eager(x).float()
      eager_ms = [time_ms(lambda: eager(x), SERVE_STEPS)
                  for _ in range(SERVE_WINDOWS)]
    got = served[(paths["bf16"], b)]
    int8 = served[(paths["int8"], b)]
    if got.shape != (b, config.image_size, config.image_size, 3) or (
        got.dtype != torch.float32):
      fail(f"batch {b}: served images {tuple(got.shape)} {got.dtype}")
    if not (bool(torch.isfinite(got).all()) and float(got.min()) >= 0
            and float(got.max()) <= 1):
      fail(f"batch {b}: served images outside [0, 1]")
    err = float((got - want).abs().max())
    equal = float((got == want).float().mean())
    int8_dev = float((int8 - got).abs().max())
    print(f"  batch {b}: bf16 artifact against the eager EMA G: max |diff| "
          f"{err:.3e} (tolerance {SERVE_ATOL}), {equal:.4f} of pixels "
          f"equal; int8 against bf16 max |diff| {int8_dev:.4f}", flush=True)
    if err > SERVE_ATOL:
      fail(f"batch {b}: the served images differ from eager G by {err}")
    for name in ("bf16", "int8"):
      entry = report[paths[name]]["batches"][str(b)]
      ms = statistics.median(entry["ms_windows"])
      print(f"    {name} artifact: {ms:.3f} ms a request (median of "
            f"{SERVE_WINDOWS} windows of {SERVE_STEPS}; windows "
            f"{[round(v, 3) for v in entry['ms_windows']]}), "
            f"{b / ms * 1e3:.2f} images/s; first call "
            f"{entry['first_call_seconds']:.3f} s", flush=True)
    ms = statistics.median(eager_ms)
    print(f"    eager EMA G: {ms:.3f} ms a request, {b / ms * 1e3:.2f} "
          f"images/s ({card})", flush=True)
  for name in ("bf16", "int8"):
    print(f"  {name} artifact loaded in "
          f"{report[paths[name]]['load_seconds']:.2f} s", flush=True)

  # The tower's input resize (``utils/pretrained.py``) at the 256 px
  # configuration's 256 -> 224, where it antialiases: the card's result
  # against the CPU's on the same images, within the 1e-5 that holds the
  # CPU result to ``jax.image.resize`` in tests/test_torch_pretrained.py.
  images = torch.rand(8, 256, 256, 3, generator=torch.Generator()
                      .manual_seed(3))
  want = pretrained.resize_for_tower(images)
  got = pretrained.resize_for_tower(images.to(dev)).cpu()
  err = float((got - want).abs().max())
  print(f"  tower resize 256 -> 224 (antialiased) on the card against the "
        f"CPU: max |diff| {err:.3e} (tolerance 1e-5)", flush=True)
  if not err <= 1e-5:
    fail(f"the tower's resize on the card differs from the CPU's by {err}")


SHARDED_SHAPES = ((28, 56), (64, 128))   # images x captions a process
DDP_WORLD = 2


def check_kernels_sharded(torch, records):
  """Phase 8a: kernels B, C and D against their plain versions at the
  shapes the sharded dispatch gives them (each process's images against
  every caption: I = B/N, C = B for the flagship's 56 and the 256 px
  microbatch's 128 over 2 processes), two calls of C and D bit for bit,
  timed and bounded; kept in each record under ``sharded_<I>x<C>``."""
  from xmcgan_image_generation_tpu_torch.ops.attention import padding_mask
  from xmcgan_image_generation_tpu_torch.ops.contrastive import l2_normalize
  from xmcgan_image_generation_tpu_torch.ops.cuda import word_scores as ws

  dev = torch.device("cuda")
  gen = torch.Generator(device=dev).manual_seed(8)
  regions, words, dim = 256, 17, 768
  g1 = g2 = 5.0
  for images, captions in SHARDED_SHAPES:
    label = f"I = {images}, C = {captions}"
    max_len = torch.randint(3, words + 1, (captions, 1), device=dev,
                            generator=gen)
    mask = padding_mask(max_len.float(), words).contiguous()
    wn = l2_normalize(torch.randn(captions, words, dim, device=dev,
                                  generator=gen)).contiguous()
    rn = l2_normalize(torch.randn(images, regions, dim, device=dev,
                                  generator=gen)).contiguous()
    g = torch.randn(captions, images, device=dev, generator=gen)
    saved = ws.new_saved(rn, wn)
    out = {name: {"library_ms": None} for name in (
        "word_scores_fwd", "word_scores_drn", "word_scores_dwn")}
    got = ws.scores(rn, wn, mask, g1, g2, saved)
    errs = {"word_scores_fwd": (
        float((got - ws.scores_plain(rn, wn, mask, g1, g2)).abs().max()),
        1e-4)}
    for name, fn, plain in (("word_scores_drn", ws.drn, ws.drn_plain),
                            ("word_scores_dwn", ws.dwn, ws.dwn_plain)):
      d_got = fn(rn, wn, mask, g, saved, g1, g2)
      d_again = fn(rn, wn, mask, g, saved, g1, g2)
      d_want = plain(rn, wn, mask, g, g1, g2)
      if not torch.equal(d_got, d_again):
        fail(f"two {name} calls differ at {label}")
      errs[name] = (float((d_got - d_want).abs().max()),
                    1e-4 * float(d_want.abs().max()))
    for name, (err, tol) in errs.items():
      print(f"  {name}, {label}: max|kernel - plain| = {err:.3e} "
            f"(tolerance {tol:.1e}) {'ok' if err <= tol else 'FAIL'}",
            flush=True)
      if err > tol:
        fail(f"{name} disagrees with its plain version at {label}")
      out[name]["max_abs_err"] = err
    x = rn.clone().requires_grad_()
    s_plain = ws.scores_plain(x, wn, mask, g1, g2)
    y = wn.clone().requires_grad_()
    s_plain_w = ws.scores_plain(rn, y, mask, g1, g2)
    out["word_scores_fwd"]["ms"] = time_ms(
        lambda: ws.scores(rn, wn, mask, g1, g2, saved))
    out["word_scores_fwd"]["plain_ms"] = time_ms(
        lambda: ws.scores_plain(rn, wn, mask, g1, g2))
    out["word_scores_drn"]["ms"] = time_ms(
        lambda: ws.drn(rn, wn, mask, g, saved, g1, g2))
    out["word_scores_drn"]["plain_ms"] = time_ms(
        lambda: torch.autograd.grad(s_plain, x, g.t(), retain_graph=True))
    out["word_scores_dwn"]["ms"] = time_ms(
        lambda: ws.dwn(rn, wn, mask, g, saved, g1, g2))
    out["word_scores_dwn"]["plain_ms"] = time_ms(
        lambda: torch.autograd.grad(s_plain_w, y, g.t(), retain_graph=True))
    del s_plain, s_plain_w
    word_scores_bounds(out, images, regions, words, dim,
                       saved.numel() * saved.element_size(),
                       captions=captions)
    for name, rec in out.items():
      # Phase 8b's step runs the flagship's shape and records its counts;
      # no phase runs the 256 px microbatch over two processes.
      rec["launches"] = None
      records[name][f"sharded_{images}x{captions}"] = rec
      print(f"  {name}, {label}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})", flush=True)


def ddp_config():
  """The flagship configuration in float32 for one outer step."""
  config = flagship_config()
  config.update(dtype="float32", num_train_steps=1)
  return config


def ddp_super_batch(config):
  import numpy as np

  from xmcgan_image_generation_tpu_torch.data import synthetic

  return synthetic.super_batch(config, np.random.default_rng(0))


def ddp_step(torch, config, host_batch, dev):
  """One outer step from the seed's state on this process's host rows;
  returns the state, the losses, what it launched and communicated
  (every count set to 0 just before the step, read just after) and its
  seconds (host clock, the card synchronized)."""
  from xmcgan_image_generation_tpu_torch.engine import xmc_gan
  from xmcgan_image_generation_tpu_torch.engine.state import (
      broadcast_state,
      create_train_state,
  )
  from xmcgan_image_generation_tpu_torch.engine.step import train_step
  from xmcgan_image_generation_tpu_torch.ops.cuda import ntxent
  from xmcgan_image_generation_tpu_torch.ops.cuda import word_scores as ws
  from xmcgan_image_generation_tpu_torch.parallel import collectives

  state = create_train_state(config, dev, seed=config.seed)
  additional = xmc_gan.create_additional_data(config, dev)
  broadcast_state(state)
  batch = {k: torch.from_numpy(v).to(dev) for k, v in host_batch.items()}
  counters = {"ntxent": ntxent.ntxent_stats, "ntxent_bwd": ntxent.ntxent_bwd,
              "word_scores_fwd": ws.scores, "word_scores_drn": ws.drn,
              "word_scores_dwn": ws.dwn}
  torch.cuda.synchronize()
  for fn in counters.values():
    fn.launches = 0
  collectives.reset_counts()
  start = time.perf_counter()
  _, metrics = train_step(state, batch, config, additional)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - start
  launches = {name: fn.launches for name, fn in counters.items()}
  comm = collectives.counts()
  losses = {k: float(v) for k, v in metrics.items()}
  return state, losses, launches, comm, seconds


def state_tensors(state):
  """Parameters and buffers (BatchNorm statistics, ``u0``) of G and D,
  and the EMA, by name."""
  out = {}
  for tag, module in (("G", state.generator), ("D", state.discriminator)):
    for name, t in module.state_dict().items():
      out[f"{tag}/{name}"] = t
  for name, t in state.ema_params.items():
    out[f"EMA/{name}"] = t
  return out


def adam_gradients(state, beta1):
  """Each network's gradients as Adam's first moment reads them,
  ``mu / (1 - beta1)``: G's joint-update gradient (one update), D's
  ``beta1 g_critic + g_joint`` (two), by name."""
  out = {}
  for tag, module, opt in (("G", state.generator, state.g_opt),
                           ("D", state.discriminator, state.d_opt)):
    for name, p in module.named_parameters():
      if p in opt.state:
        out[f"{tag}/{name}"] = opt.state[p]["exp_avg"] / (1 - beta1)
  return out


def ddp_tolerance(name, ref):
  """``tests/test_torch_step.py``'s tolerances for one outer step:
  parameters 2 lr per Adam step (G one step at 1e-4, D two at 4e-4),
  ``u0`` 1e-3, batch statistics 1e-4 relative and 1e-5 absolute, the
  EMA a tenth of G's."""
  if name.startswith("G/") and name.endswith((".mean", ".var")):
    return 1e-5 + 1e-4 * float(ref.abs().max())
  if name.startswith("D/") and name.endswith(".u0"):
    return 1e-3
  return {"G": 2e-4, "D": 2 * 4e-4 * 2, "EMA": 2e-5}[name.split("/")[0]]


def update_gradients(torch, config, host_batch, dev):
  """Each update's gradients from the seed's state, read from Adam's
  first moment after that one update: D's in the critic update on
  sub-batch 0 (``critic/D/...``), G's and D's in the joint update alone
  on the last sub-batch (``joint/G/...``, ``joint/D/...``).  Each starts
  from the seed's state, so that Adam's first step, which moves a
  parameter by about lr whatever its gradient's size, does not carry one
  update's float noise into the next's gradients."""
  from xmcgan_image_generation_tpu_torch.engine import registry
  from xmcgan_image_generation_tpu_torch.engine import xmc_gan
  from xmcgan_image_generation_tpu_torch.engine.state import (
      broadcast_state,
      create_train_state,
  )
  from xmcgan_image_generation_tpu_torch.engine.step import split_batch
  from xmcgan_image_generation_tpu_torch.parallel import collectives

  gan_model = registry.get_gan_algorithm(config)
  batch = {k: torch.from_numpy(v).to(dev) for k, v in host_batch.items()}
  subs = split_batch(collectives.gather_batch(batch),
                     config.d_step_per_g_step)
  out = {}
  for label in ("critic", "joint"):
    state = create_train_state(config, dev, seed=config.seed)
    broadcast_state(state)
    if label == "critic":
      gan_model.train_d(state, subs[0], config)
    else:
      gan_model.train_g_d(state, subs[-1], config,
                          xmc_gan.create_additional_data(config, dev))
    for name, g in adam_gradients(state, config.beta1).items():
      if label == "joint" or name.startswith("D/"):
        out[f"{label}/{name}"] = g
    del state
  return out


# The largest relative gap allowed between two runs' gradients of one
# update's network (`gradient_gaps`).
GRADIENT_GAP = 2e-3


def gradient_gaps(got, want):
  """``|got - want| / |want|`` over each update's network's gradients
  taken as one vector (``critic/D``, ``joint/G``, ``joint/D`` of
  `update_gradients`), Euclidean norms."""
  sums = {}
  for name, w in want.items():
    total = sums.setdefault(name.rsplit("/", 1)[0], [0.0, 0.0])
    total[0] += float((got[name].float() - w.float()).square().sum())
    total[1] += float(w.float().square().sum())
  return {group: (d / w) ** 0.5 for group, (d, w) in sums.items()}


def _ddp_child(rank, port, tmp):
  """Phase 8b's process ``rank`` of two on one card (gloo)."""
  import torch

  from xmcgan_image_generation_tpu_torch.ops.attention import padding_mask
  from xmcgan_image_generation_tpu_torch.ops.cuda import word_scores as ws
  from xmcgan_image_generation_tpu_torch.parallel import collectives
  from xmcgan_image_generation_tpu_torch.parallel.mesh import MeshRules

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cudnn.deterministic = True
  rules = MeshRules.create(-1, 1, device="cuda:0", rank=rank,
                           world_size=DDP_WORLD, backend="gloo",
                           init_method=f"tcp://127.0.0.1:{port}")
  mesh, dev = rules.mesh, rules.mesh.device
  config = ddp_config()
  full = ddp_super_batch(config)
  rows = next(iter(full.values())).shape[0] // DDP_WORLD
  host = {k: v[rank * rows:(rank + 1) * rows] for k, v in full.items()}
  state, losses, launches, comm, step_s = ddp_step(torch, config, host,
                                                   dev)
  grads = adam_gradients(state, config.beta1)
  tensors = dict(state_tensors(state),
                 **{f"grad/{k}": v for k, v in grads.items()})

  # Replicas bit for bit: the elementwise max and min over the processes
  # equal this process's values.
  names = list(tensors)
  flat = torch.cat([tensors[n].detach().float().reshape(-1) for n in names])
  hi = collectives.all_reduce(flat, "max", mesh)
  lo = -collectives.all_reduce(-flat, "max", mesh)
  differ = (hi != flat) | (lo != flat)
  sizes = [tensors[n].numel() for n in names]
  differing = [n for n, d in zip(names, differ.split(sizes)) if bool(d.any())]
  del flat, hi, lo, differ
  # Every process takes part: the updates run the collectives.
  update_grads = update_gradients(torch, config, host, dev)

  result = dict(rank=rank, losses=losses, launches=launches, comm=comm,
                step_seconds=step_s, differing=differing[:10],
                num_differing=len(differing))
  if rank == 0:
    ref = torch.load(os.path.join(tmp, "world1.pt"), weights_only=True)
    worst, worst_name = 0.0, None
    for name, t in state_tensors(state).items():
      want = ref["tensors"][name].to(dev)
      err = float((t.detach().float() - want.float()).abs().max())
      ratio = err / ddp_tolerance(name, want)
      if ratio > worst:
        worst, worst_name = ratio, name
    result.update(param_worst_ratio=worst, param_worst_name=worst_name,
                  grad_gaps=gradient_gaps(update_grads, {
                      k: v.to(dev) for k, v in ref["grads"].items()}),
                  loss_rel={k: abs(v - ref["losses"][k]) / max(
                      abs(ref["losses"][k]), 1e-6)
                      for k, v in losses.items()})
  del state, tensors, grads, update_grads

  # The sharded word scores with both gradients (kernels B, C and D and
  # the word gradient's sum over processes) at the flagship's 56, held to
  # the one-process op on every process's rows.
  gen = torch.Generator(device=dev).manual_seed(80)
  b, regions, words, dim = 56, 256, 17, 768
  region = torch.randn(b, regions, dim, device=dev, generator=gen)
  word = torch.randn(b, words, dim, device=dev, generator=gen)
  max_len = torch.randint(3, words + 1, (b, 1), device=dev,
                          generator=gen).float()
  g = torch.randn(b, b, device=dev, generator=gen)
  mask = padding_mask(max_len, words)
  counters = {"word_scores_fwd": ws.scores, "word_scores_drn": ws.drn,
              "word_scores_dwn": ws.dwn}
  for fn in counters.values():
    fn.launches = 0
  local = slice(rank * b // DDP_WORLD, (rank + 1) * b // DDP_WORLD)
  x = region[local].clone().requires_grad_()
  y = word[local].clone().requires_grad_()
  scores = ws.make_sharded_word_scores(mesh)(x, y, mask[local])
  scores.backward(g)
  torch.cuda.synchronize()
  result["sharded_launches"] = {n: fn.launches for n, fn in counters.items()}
  x1 = region.clone().requires_grad_()
  y1 = word.clone().requires_grad_()
  want = ws.word_scores(x1, y1, mask)
  want.backward(g)
  errs = {}
  for what, got, ref_t in (("scores", scores.detach(), want.detach()),
                           ("d_region", x.grad, x1.grad[local]),
                           ("d_word", y.grad, y1.grad[local])):
    errs[what] = (float((got - ref_t).abs().max()),
                  (1e-5 if what == "scores" else
                   1e-4 * float(ref_t.abs().max())))
  result["sharded_errors"] = errs
  with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
    json.dump(result, f)
  rules.shutdown()


def _free_port():
  import socket

  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    return sock.getsockname()[1]


def check_nccl_world1(torch):
  """Phase 8c: a world-size-1 NCCL group, and one test-config step
  through the collectives, against the same step without a group."""
  from xmcgan_image_generation_tpu_torch.configs import coco_xmc
  from xmcgan_image_generation_tpu_torch.parallel import collectives
  from xmcgan_image_generation_tpu_torch.parallel.mesh import MeshRules

  config = coco_xmc.get_test_config()
  config.update(dtype="float32", scale_fused_convs=True, batch_size=8,
                use_pallas=True)
  host = ddp_super_batch(config)
  dev = torch.device("cuda")
  _, plain, _, _, _ = ddp_step(torch, config, host, dev)
  rules = MeshRules.create(-1, 1, device="cuda", rank=0, world_size=1,
                           backend="nccl",
                           init_method=f"tcp://127.0.0.1:{_free_port()}")
  try:
    _, losses, launches, comm, _ = ddp_step(torch, config, host,
                                            rules.mesh.device)
  finally:
    rules.shutdown()
  worst = max(abs(losses[k] - plain[k]) / max(abs(plain[k]), 1e-6)
              for k in plain)
  calls = sum(c["calls"] for c in comm.values())
  print(f"phase 8c: NCCL world size 1 ({rules.mesh.backend}): test-config "
        f"step through {calls} collectives {json.dumps(comm)}; launches "
        f"{json.dumps(launches)}; max relative loss difference to the step "
        f"without a group {worst:.3e} (tolerance 1e-4)", flush=True)
  if worst > 1e-4 or not calls or launches["word_scores_fwd"] <= 0:
    fail("the NCCL world-1 step disagrees or ran no collective or kernel")


def ddp_phase(torch, card, records):
  """Phase 8b: two processes on the one card over gloo (NCCL refuses two
  ranks on one device) take one flagship outer step in float32 with
  deterministic cuDNN on the fixed 2 x 56 super-batch, each on its host
  rows; held to the one-process step on the same super-batch.  Two
  processes on one card give no multi-GPU speed: this checks the
  semantics and the collectives on the card."""
  import torch.multiprocessing as mp

  config = ddp_config()
  dev = torch.device("cuda")
  torch.backends.cudnn.deterministic = True
  state, losses, launches1, _, world1_s = ddp_step(
      torch, config, ddp_super_batch(config), dev)
  tensors = {k: v.detach().cpu() for k, v in state_tensors(state).items()}
  del state
  host = ddp_super_batch(config)
  grads = update_gradients(torch, config, host, dev)
  # The one-process step's own sensitivity: z moved by a float32 rounding.
  nudged = dict(host, z=(host["z"] * (1 + 1e-6)).astype(host["z"].dtype))
  sensitivity = gradient_gaps(
      update_gradients(torch, config, nudged, dev), grads)
  grads = {k: v.cpu() for k, v in grads.items()}
  torch.backends.cudnn.deterministic = False
  with tempfile.TemporaryDirectory() as tmp:
    torch.save({"losses": losses, "tensors": tensors, "grads": grads},
               os.path.join(tmp, "world1.pt"))
    del tensors, grads
    torch.cuda.empty_cache()
    mp.start_processes(_ddp_child, args=(_free_port(), tmp),
                       nprocs=DDP_WORLD, start_method="spawn")
    results = []
    for rank in range(DDP_WORLD):
      with open(os.path.join(tmp, f"rank{rank}.json")) as f:
        results.append(json.load(f))
  r0 = results[0]
  print(f"  world 1: losses {json.dumps(losses)}; launches "
        f"{json.dumps(launches1)}; step {world1_s:.3f} s ({card})",
        flush=True)
  for res in results:
    print(f"  rank {res['rank']}: losses {json.dumps(res['losses'])}; "
          f"launches {json.dumps(res['launches'])}; step "
          f"{res['step_seconds']:.3f} s; tensors differing from the other "
          f"rank: {res['num_differing']} {res['differing']}", flush=True)
    print(f"  rank {res['rank']}: collectives in the outer step "
          f"{json.dumps(res['comm'])}", flush=True)
  worst_loss = max(r0["loss_rel"].values())
  gaps = r0["grad_gaps"]
  print(f"  world 2 against world 1: max relative loss difference "
        f"{worst_loss:.3e} (tolerance 1e-4); gradients of the critic "
        f"update and of the joint update alone, from the seed's state "
        f"(Adam's mu / (1 - beta1)), |difference| / |world 1| by network "
        f"{json.dumps(gaps)} (tolerance {GRADIENT_GAP:.0e}); world 1 "
        f"itself with z scaled by 1 + 1e-6: {json.dumps(sensitivity)}; "
        f"worst parameter / buffer max|difference| / tolerance "
        f"{r0['param_worst_ratio']:.6f} ({r0['param_worst_name']}; "
        f"tests/test_torch_step.py's tolerances)", flush=True)
  for res in results:
    for what, (err, tol) in res["sharded_errors"].items():
      print(f"  rank {res['rank']}: make_sharded_word_scores, both "
            f"gradients, {what} against the one-process op: {err:.3e} "
            f"(tolerance {tol:.1e}); launches "
            f"{json.dumps(res['sharded_launches'])}", flush=True)
      if err > tol:
        fail(f"rank {res['rank']}: sharded word scores' {what} disagrees")
  if (worst_loss > 1e-4 or max(gaps.values()) > GRADIENT_GAP
      or r0["param_worst_ratio"] > 1.0):
    fail("the two-process step disagrees with the one-process step")
  if any(res["num_differing"] for res in results):
    fail("the two replicas differ after one step")
  if any(res["losses"] != r0["losses"] for res in results):
    fail("the ranks report different losses")
  for name in ("ntxent", "ntxent_bwd", "word_scores_fwd", "word_scores_drn"):
    for res in results:
      if res["launches"][name] <= 0:
        fail(f"rank {res['rank']}: kernel {name} was not launched")
  for res in results:
    if min(res["sharded_launches"].values()) <= 0:
      fail(f"rank {res['rank']}: the sharded op launched "
           f"{res['sharded_launches']}")
  images, captions = SHARDED_SHAPES[0]
  for name in ("word_scores_fwd", "word_scores_drn", "word_scores_dwn"):
    sub = records[name][f"sharded_{images}x{captions}"]
    sub["launches"] = r0["launches"][name]
    sub["launches_per_rank"] = [res["launches"][name] for res in results]
    sub["launches_in_op_check"] = [res["sharded_launches"][name]
                                   for res in results]


EVAL_WORLD = 2            # phase 9's processes on the one card
EVAL_DEVICE = "cuda:0"    # the card both use
EVAL_WORKERS = 2          # loader workers a process in phase 9
HEARTBEAT_S = 0.5         # phase 9a's heartbeat interval
# Phase 9a's tolerances, written into PERF.md before the run that first
# held them: the two processes' merged statistics against one process's
# on the same global batches, which differ by the float64 sums' order and
# by the convolution algorithms cuDNN picks for 28 rows and for 56 (seen:
# 2.5e-8, 1.6e-6 and 8.7e-8 of these scales).  The random InceptionV3's
# features barely vary and IS is 1 + 1e-8, so IS is held through IS - 1,
# and each tolerance lies far below what a pool that lost a process's
# rows would move.
STATS_MU_TOL = 1e-6       # of max |mu|, elementwise
STATS_SIGMA_TOL = 1e-4    # of max |sigma|, elementwise
STATS_IS_EXCESS_RTOL = 1e-5   # of IS - 1
GRID_TOL = 1              # of 255, a pixel of a grid (phase 9b)


def phase9_config():
  """The flagship configuration as phases 6 and 9 score it."""
  config = flagship_config()
  config.update(eval_num=EVAL_NUM, eval_avg_num=EVAL_AVG_NUM,
                grain_worker_count=min(EVAL_WORKERS,
                                       config.grain_worker_count))
  return config


def _eval_child(rank, port, root):
  """Phase 9's process ``rank`` of two on one card (gloo): the
  evaluation service (9a), timed alone, then export (9c) and generate
  (9b) on ``root``, each through its entry point; writes ``scored{r}``
  after the service and ``rank{r}.pt`` at the end."""
  import torch
  import torch.distributed as dist

  from xmcgan_image_generation_tpu_torch import evaluate
  from xmcgan_image_generation_tpu_torch import generate as gen_lib
  from xmcgan_image_generation_tpu_torch.parallel import collectives
  from xmcgan_image_generation_tpu_torch.parallel.mesh import (
      init_process_group,
  )
  from xmcgan_image_generation_tpu_torch.utils import image_utils
  from xmcgan_image_generation_tpu_torch.utils import serving
  from xmcgan_image_generation_tpu_torch.utils import task_manager

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  writes = {"scores": 0, "grids": 0, "artifacts": 0}

  def counted(owner, name, key):
    original = getattr(owner, name)

    def call(*args, **kw):
      writes[key] += 1
      return original(*args, **kw)

    setattr(owner, name, call)

  counted(task_manager.TaskManagerWithCsvResults, "add_eval_result",
          "scores")
  counted(image_utils, "save_image", "grids")
  counted(serving, "_write_artifacts", "artifacts")
  # One group for the three modes; each joins it as it is, as under
  # torchrun (NCCL refuses two ranks on one device).
  init_process_group(EVAL_DEVICE, rank=rank, world_size=EVAL_WORLD,
                     backend="gloo", init_method=f"tcp://127.0.0.1:{port}")
  config = phase9_config()
  out = {"rank": rank, "marks": {"started": time.time()}}
  collectives.reset_counts()
  start = time.perf_counter()
  evaluate.HEARTBEAT_INTERVAL = HEARTBEAT_S
  metric = evaluate.evaluate_continuously(config, root, EVAL_DEVICE,
                                          timeout=120)
  out["marks"]["scored"] = time.time()
  out["service"] = dict(
      seconds=time.perf_counter() - start, real_seconds=metric.real_seconds,
      score_seconds=metric.last_seconds,
      generate_seconds=metric.last_generate_seconds,
      host_ms=metric.last_host_seconds / metric.last_host_batches * 1e3,
      host_batches=metric.last_host_batches, images=metric.last_images,
      counts=collectives.counts(),
      statistics={k: tuple(v) for k, v in metric.last_statistics.items()},
      real=(metric._real_mu, metric._real_sigma))
  del metric
  # The parent's references may start: the timed service is done.
  with open(os.path.join(root, f"scored{rank}"), "w"):
    pass
  collectives.reset_counts()
  out["artifacts"] = serving.export_from_workdir(config, root,
                                                 device=EVAL_DEVICE)
  out["export_counts"] = collectives.counts()
  out["marks"]["exported"] = time.time()
  collectives.reset_counts()
  gen_lib.generate(config, root, EVAL_DEVICE)
  out["generate_counts"] = collectives.counts()
  out["marks"]["generated"] = time.time()
  out["writes"] = writes
  dist.destroy_process_group()
  torch.save(out, os.path.join(root, f"rank{rank}.pt"))


def global_batches(config, world=EVAL_WORLD):
  """The global eval batches of ``world`` processes without end: each
  process's batch ``k`` of ``create_datasets(..., process_index=r,
  process_count=world)``, concatenated process-major (numpy)."""
  from xmcgan_image_generation_tpu_torch.data import pipeline

  import numpy as np

  streams = [iter(pipeline.create_datasets(
      config, seed=config.seed, process_index=r, process_count=world)[1])
      for r in range(world)]
  try:
    while True:
      parts = [next(it) for it in streams]
      yield {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
  finally:
    for it in streams:
      it.close()


def eval_reference(torch, config, root, dev):
  """Phase 9a's one-process reference: one `EvalMetric` on the global
  batches, its real statistics and one generated pass's merged
  statistics and IS (no FID)."""
  from xmcgan_image_generation_tpu_torch.engine.state import (
      create_train_state,
  )
  from xmcgan_image_generation_tpu_torch.utils import checkpoint
  from xmcgan_image_generation_tpu_torch.utils.eval_metrics import EvalMetric

  manager = checkpoint.CheckpointManager(checkpoint.checkpoints_dir(root))
  state = manager.restore(manager.latest_step(),
                          create_train_state(config, dev, seed=config.seed))
  batches = global_batches(config)
  metric = EvalMetric(batches, config, dev)
  pools, scores = metric._generated_statistics(state, None)
  batches.close()
  stats = {k: pools[k].compute() + (scores[k].compute()[0],) for k in pools}
  return (metric._real_mu, metric._real_sigma), stats, state


def stats_gaps(got, want):
  """``(max |d mu| / max |mu|, max |d sigma| / max |sigma|)``."""
  import numpy as np

  (mu, sigma), (w_mu, w_sigma) = got, want
  return (float(np.abs(mu - w_mu).max() / np.abs(w_mu).max()),
          float(np.abs(sigma - w_sigma).max() / np.abs(w_sigma).max()))


def modes_phase(torch, card, workdir, phase6):
  """Phase 9: the evaluation service (9a), generate (9b) and export (9c)
  over two processes on the one card (gloo), each against one process:
  on a workdir holding phase 4's checkpoint.  ``phase6``: phase 6's
  `EvalMetric`, the one-process service on the same checkpoint."""
  import torch.multiprocessing as mp

  from xmcgan_image_generation_tpu_torch.utils import checkpoint

  config = phase9_config()
  dev = torch.device(EVAL_DEVICE)
  step = checkpoint.list_steps(checkpoint.checkpoints_dir(workdir))[-1]
  root = os.path.join(workdir, "world2")
  ckpt_dir = checkpoint.checkpoints_dir(root)
  os.makedirs(ckpt_dir)
  src = checkpoint.CheckpointManager(
      checkpoint.checkpoints_dir(workdir)).path(step)
  os.symlink(src, os.path.join(ckpt_dir, os.path.basename(src)))
  rows = config.eval_batch_size // EVAL_WORLD
  print(f"phase 9a: evaluate_continuously over {EVAL_WORLD} processes on "
        f"the one card (gloo): phase 4's checkpoint, {config.image_size}px "
        f"G in {config.dtype}, eval_batch_size {config.eval_batch_size} "
        f"({rows} rows a process), eval_num {config.eval_num}, "
        f"eval_avg_num {config.eval_avg_num}, {config.grain_worker_count} "
        f"loader workers and {(os.cpu_count() or 1) // EVAL_WORLD} BLAS "
        f"threads a process; TRAIN_DONE lands after the first row, "
        f"heartbeats every {HEARTBEAT_S} s meanwhile", flush=True)
  # Each process takes its share of the host's cores for numpy's BLAS
  # (the `sqrtm`s), as torchrun caps each process's threads.
  saved = dict(os.environ)
  threads = str(max(1, (os.cpu_count() or 1) // EVAL_WORLD))
  os.environ.update(OMP_NUM_THREADS=threads, OPENBLAS_NUM_THREADS=threads)
  try:
    ctx = mp.start_processes(_eval_child, args=(_free_port(), root),
                             nprocs=EVAL_WORLD, join=False,
                             start_method="spawn")
  finally:
    os.environ.clear()
    os.environ.update(saved)
  servers = []
  try:
    (results, want, real, stats, reference_s, served,
     timeline) = _phase9_run(torch, config, workdir, root, ctx, dev, step,
                             servers)
  finally:
    for proc in ctx.processes:
      if proc.is_alive():
        proc.terminate()
    for server in servers:
      if server.poll() is None:
        server.kill()
  print(f"  phase 9 timeline, seconds from the spawn: {json.dumps(timeline)}",
        flush=True)
  _phase9_checks(torch, card, config, workdir, root, step, phase6, results,
                 want, real, stats, reference_s, *served,
                 servers[0].returncode)


def _phase9_run(torch, config, workdir, root, ctx, dev, step, servers):
  """Phase 9's runs: the service, timed alone; then the one-process
  references of 9a and 9b while the processes export and generate; and
  the torch-only serving process of 9c's artifact (appended to
  ``servers``), started first, which serves the artifact once it is
  written."""
  from xmcgan_image_generation_tpu_torch.data.prefetch import (
      numeric_tensors,
  )
  from xmcgan_image_generation_tpu_torch.engine.sampling import (
      generate_batch,
  )
  from xmcgan_image_generation_tpu_torch.utils import checkpoint
  from xmcgan_image_generation_tpu_torch.utils.task_manager import (
      TaskManager,
  )

  ckpt_dir = checkpoint.checkpoints_dir(root)
  marks = {"spawned": time.time()}
  # 9c's torch-only serving process starts the card now and waits for the
  # artifact.
  servers.append(subprocess.Popen(
      [sys.executable, "-c", _SERVE_SCRIPT,
       os.path.join(workdir, "serving", "inputs.pt"),
       os.path.join(root, "images.pt"), "1", "1",
       os.path.join(root, "serving", f"generator_ema_step{step:08d}.pt2")],
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root))
  scores_path = os.path.join(ckpt_dir, "scores.csv")
  scored = [os.path.join(root, f"scored{r}") for r in range(EVAL_WORLD)]
  scored_at = None
  # Training "ends" a heartbeat and a half after the service has scored
  # the checkpoint: until then process 0 polls, heartbeating.
  while not all(os.path.exists(p) for p in scored):
    if ctx.join(timeout=0.2):
      fail("phase 9: a process ended before its service did")
    if scored_at is None and os.path.exists(scores_path):
      scored_at = time.perf_counter()
    if scored_at is not None and (
        time.perf_counter() - scored_at > 1.5 * HEARTBEAT_S) and not (
            os.path.exists(os.path.join(ckpt_dir, "TRAIN_DONE"))):
      TaskManager(ckpt_dir).mark_training_done()
  marks["scored"] = time.time()
  # The one-process references, while the processes export and generate.
  real, stats, state = eval_reference(torch, config, root, dev)
  marks["reference"] = time.time()
  gen_batches = global_batches(config)
  next(gen_batches)   # passed over, as generate does
  want = generate_batch(state, numeric_tensors(next(gen_batches), dev),
                        config)
  gen_batches.close()
  del state
  while not ctx.join(timeout=0.2):
    pass
  marks["end"] = time.time()
  served = servers[0].communicate(timeout=300)
  marks["served"] = time.time()
  results = [torch.load(os.path.join(root, f"rank{r}.pt"),
                        weights_only=False) for r in range(EVAL_WORLD)]
  for res in results:
    marks.update({f"rank{res['rank']}_{k}": v
                  for k, v in res["marks"].items()})
  timeline = {k: round(v - marks["spawned"], 2) for k, v in sorted(
      marks.items(), key=lambda item: item[1])}
  return (results, want, real, stats, marks["reference"] - marks["scored"],
          served, timeline)


def _phase9_checks(torch, card, config, workdir, root, step, phase6,
                   results, want, real, stats, reference_s, serve_out,
                   serve_err, serve_rc):
  """Phase 9's comparisons, each against one process."""
  import csv

  import numpy as np

  from xmcgan_image_generation_tpu_torch.data import png
  from xmcgan_image_generation_tpu_torch.utils import checkpoint
  from xmcgan_image_generation_tpu_torch.utils import image_utils

  rows = config.eval_batch_size // EVAL_WORLD
  scores_path = os.path.join(checkpoint.checkpoints_dir(root), "scores.csv")
  serving_dir = os.path.join(root, "serving")
  base = f"generator_ema_step{step:08d}"
  # 9a.
  with open(scores_path) as f:
    score_rows = list(csv.DictReader(f))
  if len(score_rows) != 1:
    fail(f"phase 9a: scores.csv has {len(score_rows)} rows, expected 1")
  for key, value in score_rows[0].items():
    if not math.isfinite(float(value)):
      fail(f"phase 9a: scores.csv: {key} = {value}")
  for res in results:
    svc = res["service"]
    print(f"  rank {res['rank']}: service {svc['seconds']:.2f} s in all; "
          f"real statistics {svc['real_seconds']:.2f} s; the checkpoint "
          f"scored in {svc['score_seconds']:.2f} s (generated pass "
          f"{svc['generate_seconds']:.2f} s, {svc['images']} images of "
          f"this process); host statistics {svc['host_ms']:.2f} ms a "
          f"batch of {rows} and weight set ({svc['host_batches']} "
          f"batches); control plane {json.dumps(svc['counts'])} ({card})",
          flush=True)
  world1_host = phase6.last_host_seconds / phase6.last_host_batches * 1e3
  print(f"  world 1 (phase 6, the same checkpoint and sizes): the "
        f"checkpoint scored in {phase6.last_seconds:.2f} s (generated "
        f"pass {phase6.last_generate_seconds:.2f} s); host statistics "
        f"{world1_host:.2f} ms a batch of {config.eval_batch_size} and "
        f"weight set; one-process reference on the global batches "
        f"(statistics, no FID) {reference_s:.2f} s while the processes "
        f"exported and generated", flush=True)
  print(f"  scores.csv row: {json.dumps(score_rows[0])}", flush=True)
  r0, r1 = results
  heartbeats = r0["service"]["counts"].get("broadcast/heartbeat",
                                           {"calls": 0})["calls"]
  if heartbeats <= 0:
    fail("phase 9a: process 0 sent no heartbeat while it polled")
  for key in ("real",) + tuple(stats):
    got = [res["service"]["real"] if key == "real"
           else res["service"]["statistics"][key][:2] for res in results]
    ref = real if key == "real" else stats[key][:2]
    if not all(np.array_equal(a, b) for a, b in zip(*got)):
      fail(f"phase 9a: the processes' merged {key} statistics differ")
    mu_gap, sigma_gap = stats_gaps(got[0], ref)
    line = (f"  {key}: merged statistics against one process's: max |d mu| "
            f"{mu_gap:.3e} of max |mu| (tolerance {STATS_MU_TOL:.0e}), max "
            f"|d sigma| {sigma_gap:.3e} of max |sigma| (tolerance "
            f"{STATS_SIGMA_TOL:.0e})")
    ok = mu_gap <= STATS_MU_TOL and sigma_gap <= STATS_SIGMA_TOL
    if key != "real":
      score, w_score = r0["service"]["statistics"][key][2], stats[key][2]
      is_gap = abs(score - w_score) / abs(w_score - 1)
      line += (f"; IS {score!r} against {w_score!r}, {is_gap:.3e} of IS "
               f"- 1 (tolerance {STATS_IS_EXCESS_RTOL:.0e})")
      ok = ok and is_gap <= STATS_IS_EXCESS_RTOL
    print(line, flush=True)
    if not ok:
      fail(f"phase 9a: the {key} statistics disagree with one process's")
  # 9b.
  samples = os.path.join(root, "samples")
  names = sorted(os.listdir(samples))
  grids = ("generated_image", "ema_generated_image", "image")
  if names != sorted(f"step{step:08d}_batch0_{g}.png" for g in grids):
    fail(f"phase 9b: samples holds {names}")
  worst = 0
  for g in grids:
    path = os.path.join(samples, f"step{step:08d}_batch0_{g}.png")
    ref_path = os.path.join(workdir, f"world1_{g}.png")
    image_utils.save_image(want[g].cpu().numpy(), ref_path, config.show_num)
    with open(path, "rb") as f:
      got_px = png.decode(f.read()).astype(np.int32)
    with open(ref_path, "rb") as f:
      ref_px = png.decode(f.read()).astype(np.int32)
    diff = int(np.abs(got_px - ref_px).max())
    worst = max(worst, diff)
    print(f"  phase 9b: {g} grid {got_px.shape} of the gathered global "
          f"batch against one process's: max |diff| {diff}/255, "
          f"{float((got_px == ref_px).mean()):.6f} of values equal "
          f"(tolerance {GRID_TOL}/255)", flush=True)
  if worst > GRID_TOL:
    fail("phase 9b: process 0's grids differ from one process's")
  # 9c.
  names = sorted(os.listdir(serving_dir))
  if names != [base + ".json", base + ".pt2"]:
    fail(f"phase 9c: serving holds {names}, expected one artifact")
  if r0["artifacts"] != r1["artifacts"] or r0["artifacts"] != [
      os.path.join(serving_dir, base + ".pt2")]:
    fail(f"phase 9c: the processes returned {r0['artifacts']} and "
         f"{r1['artifacts']}")
  writes = [res["writes"] for res in results]
  print(f"  phase 9b-9c: writes by process (scores.csv rows, grids, "
        f"artifact sets): {json.dumps(writes)}; control plane in "
        f"generate {json.dumps(r0['generate_counts'])}, in export "
        f"{json.dumps(r0['export_counts'])}", flush=True)
  if writes != [{"scores": 1, "grids": 3, "artifacts": 1},
                {"scores": 0, "grids": 0, "artifacts": 0}]:
    fail("phase 9: process 1 wrote, or process 0 did not write once")
  if serve_rc != 0:
    fail(f"phase 9c: the serving process: {serve_err[-3000:]}")
  report = json.loads(serve_out.strip().splitlines()[-1])
  if report["loaded"]:
    fail(f"phase 9c: the serving process imported {report['loaded']}")
  served = torch.load(os.path.join(root, "images.pt"))
  phase7_served = torch.load(os.path.join(workdir, "serving", "images.pt"))
  phase7_bf16 = [p for p, _ in phase7_served if "_int8_" not in p][0]
  for b in SERVE_BATCHES:
    got = served[(os.path.join(serving_dir, base + ".pt2"), b)]
    ref = phase7_served[(phase7_bf16, b)]
    err = float((got - ref).abs().max())
    print(f"  phase 9c: the artifact of process 0 of two, served from a "
          f"torch-only process at batch {b}, against phase 7's: max "
          f"|diff| {err:.3e} (tolerance {SERVE_ATOL})", flush=True)
    if not err <= SERVE_ATOL:
      fail(f"phase 9c: batch {b} serves other images than phase 7's")


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
  from torch.utils import checkpoint as torch_checkpoint
  from torch.utils import _python_dispatch

  remat_api = {
      "torch.utils.checkpoint.checkpoint(context_fn=...)": "context_fn" in (
          inspect.signature(torch_checkpoint.checkpoint).parameters),
      "torch.utils.checkpoint.noop_context_fn": hasattr(
          torch_checkpoint, "noop_context_fn"),
      "torch.utils._python_dispatch.TorchDispatchMode": hasattr(
          _python_dispatch, "TorchDispatchMode"),
  }
  print(f"  remat's API (models/xmc_net.py): {json.dumps(remat_api)}",
        flush=True)
  if not all(remat_api.values()):
    fail("this torch lacks what remat uses")
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
  dev = torch.device("cuda")
  config = flagship_config()

  def timed(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"  ({label}: {time.perf_counter() - t0:.1f} s)", flush=True)
    return out

  timed("phase 3", check_kernels, torch, records)
  timed("phase 3b", check_small_step, torch)
  print(f"phase 3c: kernels A-C at the 256 px path's microbatch of "
        f"{MICROBATCH_256}", flush=True)
  timed("phase 3c", check_kernels_microbatch, torch, records, MICROBATCH_256)
  with tempfile.TemporaryDirectory() as workdir:
    timed("phase 4", train_flagship, torch, records, card, workdir, config)
    timed("phase 4c", train_256, torch, records, card,
          config.num_train_steps)
    print("phase 4d: remat on the card, one 256 px critic update",
          flush=True)
    timed("phase 4d", check_remat, torch, card)
    timed("phase 4b", real_data_phase, torch, card, dev)
    timed("phase 5", check_resume, torch, dev)
    phase6 = timed("phase 6", evaluate_flagship, torch, card, workdir,
                   config, dev)
    timed("phase 7", serve_flagship, torch, card, workdir, config, dev)
    print("phase 8a: kernels B, C and D at the sharded dispatch's shapes "
          "(images x captions a process)", flush=True)
    timed("phase 8a", check_kernels_sharded, torch, records)
    print(f"phase 8b: data parallelism, {DDP_WORLD} processes on one card "
          f"over gloo, one flagship outer step in float32", flush=True)
    timed("phase 8b", ddp_phase, torch, card, records)
    timed("phase 8c", check_nccl_world1, torch)
    timed("phase 9", modes_phase, torch, card, workdir, phase6)

  print(json.dumps({"kernels": list(records.values())}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()

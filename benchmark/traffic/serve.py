"""Serving traffic: text-to-image requests to the port's exported
generator, one caller in a closed loop.

The mix's parameters: ``batch``, images a request; ``pool``, the number
of distinct requests drawn from the seed (the caller cycles through
them); ``warmup``, requests served before the window; ``caption_len``,
the range of caption lengths; ``calibration_batch``, the examples whose
batch statistics become G's BatchNorm running averages.

Set-up draws G's weights on the card from the seed and sets its
BatchNorm running averages to the batch statistics of a training-mode
forward of the reference on seeded inputs, as a converged G would hold
them (with the initial 0 and 1, eval-mode G would not normalize at all).
It loads them into the port's G as its EMA weights, exports it with
``utils.serving.export_generator(..., batch_size=None)`` (the
configuration's dtype), saves the artifact under ``TMPDIR`` and loads it
back with ``load_exported(path, device=...)``: the program a deployment
serves.  A request hands the artifact's callable the caller's host
inputs, moved to the card, and ends when the image is on the host; its
latency is the host clock over the two.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time
from typing import Dict, List

import torch

from benchmark import trace, weights
from benchmark.reference import nets, step as ref

INPUTS = ("sentence_embedding", "embedding", "max_len", "z")


def requests(cfg, mix, seed: int, device, tag: str = "requests",
             count: int = None) -> Dict[str, torch.Tensor]:
  """``count`` (the pool's by default) requests' inputs, stacked."""
  g = weights.generator(seed, tag, device)
  n = (count or mix["pool"]) * mix["batch"]
  lo, hi = mix["caption_len"]
  return {
      "sentence_embedding": torch.randn(n, nets.BERT_DIM, generator=g,
                                        device=device),
      "embedding": torch.randn(n, nets.TEXT_LEN, nets.BERT_DIM, generator=g,
                               device=device),
      "max_len": torch.randint(lo, hi + 1, (n, 1), generator=g,
                               device=device).float(),
      "z": torch.randn(n, cfg["z_dim"], generator=g, device=device),
  }


def generator_weights(cfg, mix, seed: int, device) -> Dict[str, torch.Tensor]:
  """G's seeded parameters with calibrated running averages."""
  spec = ref.spec(cfg)["g"]
  g = weights.draw(spec, seed, "weights.g", device)
  calibration = requests(cfg, {**mix, "batch": 1}, seed, device,
                         tag="calibration", count=mix["calibration_batch"])
  g.update(ref.batch_statistics(g, cfg, calibration))
  return g


def _artifact(ctx, g_weights):
  from xmcgan_image_generation_tpu_torch.models import get_architecture
  from xmcgan_image_generation_tpu_torch.utils import serving

  gen_cls, _ = get_architecture(ctx.config)
  generator = gen_cls(ctx.config, device="meta")
  generator.load_state_dict(g_weights, assign=True)
  ema = {name: p.detach() for name, p in generator.named_parameters()}
  program = serving.export_generator(generator, ema, ctx.config,
                                     batch_size=None, device=ctx.device)
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "generator.pt2")
    torch.export.save(program, path)
    del program, generator, ema
    return serving.load_exported(path, device=ctx.device).module()


def _rows(pool: Dict[str, torch.Tensor], index: int, batch: int):
  return [pool[k][index * batch:(index + 1) * batch] for k in INPUTS]


def run(ctx):
  """Set-up and the window; returns the record and the served images."""
  cfg, mix, device, seed = ctx.cfg, ctx.mix, ctx.device, ctx.seed
  batch, count = mix["batch"], mix["pool"]
  g_weights = generator_weights(cfg, mix, seed, device)
  module = _artifact(ctx, g_weights)
  del g_weights
  pool = {k: v.cpu() for k, v in requests(cfg, mix, seed, device).items()}
  warm = {k: v.cpu() for k, v in requests(cfg, mix, seed, device, "warmup",
                                          mix["warmup"]).items()}

  def serve(inputs) -> torch.Tensor:
    return module(*[x.to(device) for x in inputs]).cpu()

  record = ctx.new_record(kind="serve")
  served: List[torch.Tensor] = []
  with torch.no_grad():
    for i in range(mix["warmup"]):
      serve(_rows(warm, i, batch))
    if ctx.seconds > 0:
      spans = trace.Spans()
      latencies = []
      ctx.start_window(record)
      with ctx.tracing() as tracer:
        start_ns = trace.now_ns()
        start = time.perf_counter()
        while True:
          inputs = _rows(pool, len(served) % count, batch)
          a_ns, a = trace.now_ns(), time.perf_counter()
          image = serve(inputs)
          b = time.perf_counter()
          spans.add("request", a_ns, trace.now_ns())
          latencies.append((b - a) * 1e3)
          served.append(image)
          if b - start >= ctx.seconds:
            break
        record.window_s = time.perf_counter() - start
        end_ns = trace.now_ns()
      record.latencies_ms = latencies
      record.work = len(served)
      record.images = len(served) * batch
      ctx.end_window(record, tracer, start_ns, end_ns, spans)
  del module
  gc.collect()
  if device.type == "cuda":
    torch.cuda.empty_cache()
  return record, served


def reference_images(ctx, indices, rounding=None) -> Dict[int, torch.Tensor]:
  """The reference's images (float32 on the host) of the pool's requests
  ``indices``, in blocks of rows."""
  cfg, mix, device = ctx.cfg, ctx.mix, ctx.device
  g = generator_weights(cfg, mix, ctx.seed, device)
  pool = requests(cfg, mix, ctx.seed, device)
  batch, block = mix["batch"], max(1, 64 // mix["batch"])
  out = {}
  indices = sorted(set(indices))
  for start in range(0, len(indices), block):
    part = indices[start:start + block]
    rows = torch.cat([torch.arange(i * batch, (i + 1) * batch)
                      for i in part]).to(device)
    images = ref.generate(g, cfg, {k: v[rows] for k, v in pool.items()},
                          rounding=rounding).cpu()
    for j, i in enumerate(part):
      out[i] = images[j * batch:(j + 1) * batch]
  return out


def check(ctx, served: List[torch.Tensor], rounding=None) -> Dict[str, float]:
  """``image``: the largest pixel gap of any served image from the
  reference's image of its request; ``image_rms``: the root mean square
  of the gaps of every pixel served."""
  if not served:
    return {"image": float("inf"), "image_rms": float("inf")}
  count = ctx.mix["pool"]
  want = reference_images(ctx, [i % count for i in range(len(served))],
                          rounding)
  gap, squares, pixels = 0.0, 0.0, 0
  for i, image in enumerate(served):
    diff = (image.float() - want[i % count]).abs()
    gap = max(gap, float(diff.max()))
    squares += float((diff.double() ** 2).sum())
    pixels += diff.numel()
  return {"image": gap, "image_rms": (squares / pixels) ** 0.5}

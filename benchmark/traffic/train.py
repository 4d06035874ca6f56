"""Training traffic: outer steps of the port's trainer on seeded
super-batches.

The mix's parameters: ``pool``, the number of distinct super-batches
drawn from the seed (the feed cycles through them); ``verified_steps``,
the first outer steps, which set-up takes and the reference follows;
``prefetch``, the ``DevicePrefetcher``'s depth; ``caption_len``, the
range of caption lengths.

Set-up builds the port's training state from the benchmark's seeded
weights (G, D and the frozen ResNet-50, drawn on the card; the port's
constructors build on ``meta`` and draw nothing), its Adam optimizers and
EMA, and a `DevicePrefetcher` over the seeded feed: the pieces of
``train.setup`` with the feed swapped.  It drives that state through the
verified steps with ``train.timed_step``, the loop's own call, reading
the losses and Adam's first moments after the first and the state after
the last.  The window then calls ``train.timed_step(..., sync=False)``
as ``train.train`` does between logging steps, and ends on
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from benchmark import compare, trace, weights
from benchmark.reference import nets, step as ref


def superbatch(cfg, mix, seed: int, index: int, device) -> Dict[str, torch.Tensor]:
  """Super-batch ``index`` of the seed in the loader's schema: uint8
  images, word and sentence embeddings, caption lengths and latents."""
  g = weights.generator(seed, f"data.{index}", device)
  n, s = cfg["batch_size"] * cfg["d_step_per_g_step"], cfg["image_size"]
  lo, hi = mix["caption_len"]
  return {
      "image": torch.randint(0, 256, (n, s, s, 3), generator=g,
                             device=device, dtype=torch.uint8),
      "embedding": torch.randn(n, nets.TEXT_LEN, nets.BERT_DIM, generator=g,
                               device=device),
      "max_len": torch.randint(lo, hi + 1, (n, 1), generator=g,
                               device=device).float(),
      "sentence_embedding": torch.randn(n, nets.BERT_DIM, generator=g,
                                        device=device),
      "z": torch.randn(n, cfg["z_dim"], generator=g, device=device),
  }


class Feed:
  """The loader's side of the prefetcher: host super-batches in turn."""

  def __init__(self, pool):
    self.pool = pool
    self.index = 0

  def __iter__(self):
    return self

  def __next__(self):
    batch = self.pool[self.index % len(self.pool)]
    self.index += 1
    return dict(batch)

  def get_state(self):
    return {"index": self.index}

  def close(self):
    pass


def seeded_weights(cfg, seed: int, device):
  spec = ref.spec(cfg)
  return spec, {net: weights.draw(spec[net], seed, f"weights.{net}", device)
                for net in spec}


def _port_state(config, cfg, w, device):
  from xmcgan_image_generation_tpu_torch.engine.state import (
      TrainState,
      create_optimizers,
  )
  from xmcgan_image_generation_tpu_torch.models import get_architecture
  from xmcgan_image_generation_tpu_torch.utils import pretrained

  gen_cls, disc_cls = get_architecture(config)
  g = gen_cls(config, device="meta")
  g.load_state_dict(w["g"], assign=True)
  d = disc_cls(config, device="meta")
  d.load_state_dict(w["d"], assign=True)
  g_opt, d_opt = create_optimizers(config, g, d)
  ema = {name: p.detach().clone() for name, p in g.named_parameters()}
  state = TrainState(step=0, generator=g, discriminator=d, g_opt=g_opt,
                     d_opt=d_opt, ema_params=ema)
  additional = {}
  if cfg["pretrained_image_contrastive"]:
    tower = pretrained.get_pretrained_model(device="meta")
    tower.load_state_dict(w["tower"], assign=True)
    additional["image_model"] = tower
  return state, additional


def _first_moments(module, opt) -> Dict[str, float]:
  """|Adam's m| of each parameter (0 where the optimizer holds none)."""
  return compare.norms({
      name: opt.state[p].get("exp_avg", torch.zeros(()))
      for name, p in module.named_parameters()})


def _statistics(spec, buffers) -> Dict[str, torch.Tensor]:
  """G's BatchNorm running averages, on the host."""
  return {n: buffers[n].detach().float().cpu().clone() for n in spec["g"]
          if n.endswith((".mean", ".var"))}


def _final(spec, cfg, seed, device, params, ema, buffers) -> Dict:
  """Norms of the changes from the seeded start."""
  p0 = {net: weights.draw(spec[net], seed, f"weights.{net}", device)
        for net in ("g", "d")}
  names = {net: ref.trained(spec[net]) for net in ("g", "d")}
  change = {net: compare.norms({n: params[net][n] - p0[net][n]
                                for n in names[net]}) for net in ("g", "d")}
  ema_change = compare.norms({n: ema[n] - p0["g"][n] for n in names["g"]})
  bn = compare.norms({n: buffers["g"][n] - p0["g"][n] for n in spec["g"]
                      if n.endswith((".mean", ".var"))})
  del p0
  return dict(change=change, ema=ema_change, bn=bn)


def run(ctx):
  """Set-up, the verified steps and the window; returns the record and
  the program's `compare.Readings`."""
  from xmcgan_image_generation_tpu_torch import train as train_lib
  from xmcgan_image_generation_tpu_torch.data.prefetch import (
      DevicePrefetcher,
  )

  cfg, mix, device, seed = ctx.cfg, ctx.mix, ctx.device, ctx.seed
  spec, w = seeded_weights(cfg, seed, device)
  state, additional = _port_state(ctx.config, cfg, w, device)
  del w
  pool = [{k: v.cpu() for k, v in superbatch(cfg, mix, seed, i, device).items()}
          for i in range(mix["pool"])]
  batches = DevicePrefetcher(Feed(pool), device, size=mix["prefetch"])
  program = (state, additional, batches)
  losses, m1 = [], None
  try:
    for _ in range(mix["verified_steps"]):
      metrics, _, _, _ = train_lib.timed_step(program, ctx.config, device,
                                              sync=True)
      losses.append({k: float(metrics[k]) for k in ref.LOSSES})
      if m1 is None:
        m1 = {"g": _first_moments(state.generator, state.g_opt),
              "d": _first_moments(state.discriminator, state.d_opt)}
        bn1 = _statistics(spec, dict(state.generator.named_buffers()))
    final = _final(
        spec, cfg, seed, device,
        {"g": dict(state.generator.named_parameters()),
         "d": dict(state.discriminator.named_parameters())},
        state.ema_params,
        {"g": dict(state.generator.named_buffers()),
         "d": dict(state.discriminator.named_buffers())})
    readings = compare.Readings(losses=losses, m1=m1, bn1=bn1, **final)

    record = ctx.new_record(kind="train")
    record.data_seconds = []
    if ctx.seconds > 0:
      _window(ctx, record, train_lib, program)
  finally:
    batches.close()
  del program, state, additional, batches
  gc.collect()
  if device.type == "cuda":
    torch.cuda.empty_cache()
  return record, readings


def _window(ctx, record, train_lib, program) -> None:
  cfg, device = ctx.cfg, ctx.device
  spans = trace.Spans()
  steps = 0
  ctx.start_window(record)
  with ctx.tracing() as tracer:
    start_ns = trace.now_ns()
    start = time.perf_counter()
    while True:
      a = trace.now_ns()
      _, _, data_seconds, _ = train_lib.timed_step(program, ctx.config,
                                                   device, sync=False)
      b = trace.now_ns()
      waited = a + int(data_seconds * 1e9)
      spans.add("data wait", a, waited)
      spans.add("step dispatch", waited, b)
      record.data_seconds.append(data_seconds)
      steps += 1
      if time.perf_counter() - start >= ctx.seconds:
        break
    a = trace.now_ns()
    ctx.synchronize()
    record.window_s = time.perf_counter() - start
    end_ns = trace.now_ns()
    spans.add("final synchronize", a, end_ns)
  record.steps = steps
  record.work = steps
  record.images = steps * cfg["batch_size"] * cfg["d_step_per_g_step"]
  ctx.end_window(record, tracer, start_ns, end_ns, spans)


def reference(ctx, rounding=None) -> compare.Readings:
  """The reference's readings of the verified steps, from the same seeded
  weights and super-batches, in float32 (``rounding``: the control)."""
  cfg, mix, device, seed = ctx.cfg, ctx.mix, ctx.device, ctx.seed
  spec, w = seeded_weights(cfg, seed, device)
  state = ref.new_state(cfg, w["g"], w["d"], w["tower"],
                        ref.trained(spec["g"]), ref.trained(spec["d"]))
  losses, m1 = [], None
  for i in range(mix["verified_steps"]):
    batch = superbatch(cfg, mix, seed, i, device)
    values = ref.outer_step(state, batch, cfg, rounding=rounding,
                            remat=bool(cfg["remat"]))
    losses.append({k: float(v) for k, v in values.items()})
    if m1 is None:
      m1 = {"g": compare.norms(state.g_opt.m),
            "d": compare.norms(state.d_opt.m)}
      bn1 = _statistics(spec, state.g)
    del batch
  final = _final(spec, cfg, seed, device, {"g": state.g, "d": state.d},
                 state.ema, {"g": state.g, "d": state.d})
  return compare.Readings(losses=losses, m1=m1, bn1=bn1, **final)


def check(ctx, program: compare.Readings, rounding=None) -> Dict[str, float]:
  return compare.train_numbers(program, reference(ctx, rounding))


"""XMC-GAN update rules (the JAX package's ``engine/xmc_gan.py``).

The JAX joint step runs D twice, once per gradient, and leaves XLA to
merge the two forwards.  Eager PyTorch merges nothing, so here D runs once
on ``concat(real, fake)`` and two ``torch.autograd.grad`` pulls take
``d_loss -> D params`` and ``g_loss -> G params``: the reference's
dual-cotangent form, whose equality with the two-pass form the JAX tests
show.  The pull of ``d_loss`` reaches no G parameter, so the fake images
need no detach.

With ``config.grad_accum_steps = k > 1`` each update takes its gradients
on k contiguous microbatches in turn (`engine.step.stack_microbatches`),
each graph freed before the next, so live activations are one
microbatch's; it sums them in float32, divides by k and steps each Adam
once (and the EMA once).  As in the JAX ``lax.scan``, mutable state
threads in sequence: microbatch i+1 sees the ``u0`` and G batch
statistics that microbatch i wrote, so ``u0`` (D's, and with
``g_spectral_norm`` G's in the joint update) advances k times an update.
The contrastive pools, the ResNet-50 term and the batch statistics are
each microbatch's own: a capacity knob, not a large-batch emulation.

Over a process group (`parallel`) the update functions take the global
(sub-)batch, and each (micro)batch is cut to this process's rows
(`engine.step.local_rows`) before the forward.  Every process computes
the global losses (the logits and contrastive features are gathered,
`parallel.collectives`), so the losses and metrics are the same on each;
the gradients of a process's parameters come from its own rows and are
summed over processes (`collectives.all_reduce_grads`, one flat-bucket
``all_reduce`` a bucket) once per update, after the microbatches.
``DistributedDataParallel`` is not used: its reducer hooks
``.backward()``, and the updates take ``torch.autograd.grad``.

Each update is a `utils.tracing` span (``d_update``, ``gd_update``) over
the leaves ``forward`` and ``backward`` (once a microbatch),
``reduce_grads`` (each microbatch's float32 sum, then the mean and the
sum over processes), ``adam`` (each apply) and ``ema``; they record only
while a profiler capture runs.

On one card with one microbatch an update, `engine.step.train_step`
hands the updates its `engine.graphed.StepGraphs` (``graphs``): each
update's forward and backward then run as a captured CUDA graph, and
Adam and the EMA as here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from xmcgan_image_generation_tpu_torch.engine.state import TrainState
from xmcgan_image_generation_tpu_torch.ops import contrastive as contrastive_ops
from xmcgan_image_generation_tpu_torch.ops import losses
from xmcgan_image_generation_tpu_torch.ops.images import image_to_float
from xmcgan_image_generation_tpu_torch.ops.normalization import frozen_state
from xmcgan_image_generation_tpu_torch.parallel import collectives
from xmcgan_image_generation_tpu_torch.utils import pretrained
from xmcgan_image_generation_tpu_torch.utils import tracing

Batch = Dict[str, torch.Tensor]


def create_additional_data(config, device) -> Dict[str, Any]:
  """The frozen towers the configuration asks for."""
  additional_data = {}
  if config.pretrained_image_contrastive:
    additional_data["image_model"] = pretrained.get_pretrained_model(
        checkpoint_path=config.get("resnet_ckpt_path", ""), device=device)
  return additional_data


def contrastive_totals(stats: Dict[str, torch.Tensor]):
  """(c_loss_d, c_loss_g): D trains on the real-image heads, G on the
  fake-image heads plus the fake-vs-real image head."""
  c_loss_d = stats["real_word_loss"] + stats["real_sentence_loss"]
  c_loss_g = (stats["fake_word_loss"] + stats["fake_sentence_loss"]
              + stats["image_contrastive_loss"])
  return c_loss_d, c_loss_g


def pretrained_contrastive(additional_data: Dict[str, Any],
                           real_images: torch.Tensor,
                           fake_images: torch.Tensor) -> torch.Tensor:
  """NT-Xent between the frozen tower's logits of real and fake images.

  The real branch runs without autograd; the fake branch is recomputed in
  the backward instead of keeping its 224x224 activations.
  """
  model = additional_data["image_model"]

  def logits(images):
    return pretrained.get_pretrained_embs(model, images)[1]

  with torch.no_grad():
    real_out = logits(real_images)
  # The tower draws no random numbers: no RNG state to keep (a CUDA graph
  # capture could not read it).
  fake_out = checkpoint(logits, fake_images, use_reentrant=False,
                        preserve_rng_state=False)
  loss, _, _ = contrastive_ops.nt_xent(real_out, fake_out)
  return loss


def _noise(batch: Batch, dtype) -> torch.Tensor:
  """The per-example latent, which the port's batches always carry."""
  if "z" not in batch:
    raise ValueError("the port draws no z on the device: batches carry 'z'")
  return batch["z"].to(dtype)


def _grads(loss: torch.Tensor, params, retain_graph: bool = False):
  return torch.autograd.grad(loss, params, retain_graph=retain_graph,
                             allow_unused=True, materialize_grads=True)


def _apply(opt: torch.optim.Optimizer, params, grads) -> None:
  with tracing.span("adam"):
    for p, g in zip(params, grads):
      p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def _global_logits(logit: torch.Tensor):
  """(real, fake) logits of every process's rows."""
  real_logit, fake_logit = logit.float().chunk(2)
  return (collectives.all_gather(real_logit, tag="logits"),
          collectives.all_gather(fake_logit, tag="logits"))


def _accumulated(fn, batch: Batch, config):
  """``fn(microbatch) -> (grads, losses)`` over ``grad_accum_steps``
  microbatches of the global ``batch`` in turn, each cut to this
  process's rows: the mean gradients (each a tuple of tensors), summed
  over processes, and the mean losses.  One microbatch (k = 1) is
  ``fn(local_rows(batch))``."""
  from xmcgan_image_generation_tpu_torch.engine.step import (
      local_rows,
      stack_microbatches,
  )

  k = int(config.get("grad_accum_steps", 1))
  if k <= 1:
    grads, losses = fn(local_rows(batch))
    with tracing.span("reduce_grads"):
      return tuple(collectives.all_reduce_grads(g) for g in grads), losses
  micro = stack_microbatches(batch, k)
  grad_sums = loss_sums = None
  for i in range(k):
    grads, losses = fn(local_rows({name: x[i]
                                   for name, x in micro.items()}))
    with tracing.span("reduce_grads"):
      if grad_sums is None:
        # Fresh float32 sums: two parameters may be handed one gradient.
        grad_sums = tuple([g.to(torch.float32, copy=True) for g in part]
                          for part in grads)
        loss_sums = losses
      else:
        for sums, part in zip(grad_sums, grads):
          for total, g in zip(sums, part):
            total.add_(g)
        loss_sums = {name: v + losses[name]
                     for name, v in loss_sums.items()}
  with tracing.span("reduce_grads"):
    for sums in grad_sums:
      for total in sums:
        total.div_(k)
    return (tuple(collectives.all_reduce_grads(g) for g in grad_sums),
            {name: v / k for name, v in loss_sums.items()})


def _update_grads(kind: str, fn, batch: Batch, config, graphs,
                  bound: tuple = ()):
  """`_accumulated`, or with ``graphs`` the update's graph of ``kind``
  for ``config`` and the other objects ``bound`` that ``fn`` reads
  (`engine.graphed.StepGraphs.run`)."""
  if graphs is None:
    return _accumulated(fn, batch, config)
  return graphs.run(kind, fn, batch, (config,) + bound)


def _joint_grads(state: TrainState, batch: Batch, config,
                 additional_data: Dict[str, Any]):
  """``((d_grads, g_grads), losses)`` of the joint update on one
  (micro)batch: one G and one D forward, two pulls."""
  g_net, d_net = state.generator, state.discriminator
  with tracing.span("forward"):
    real_image = image_to_float(batch["image"])
    fake_image = g_net(batch, _noise(batch, g_net.dtype))
    all_images = torch.cat([real_image, fake_image.float()])
    logit, stats = d_net(all_images, batch)
    real_logit, fake_logit = _global_logits(logit)
    c_loss_d, c_loss_g = contrastive_totals(stats)
    c_loss_g_pretrained = torch.zeros((), device=logit.device)
    if config.pretrained_image_contrastive:
      c_loss_g_pretrained = pretrained_contrastive(
          additional_data, real_image, fake_image)
    d_loss = losses.hinge_d(real_logit, fake_logit) + c_loss_d
    g_loss = losses.hinge_g(fake_logit) + c_loss_g + c_loss_g_pretrained

  with tracing.span("backward"):
    d_grads = _grads(d_loss, list(d_net.parameters()), retain_graph=True)
    g_grads = _grads(g_loss, list(g_net.parameters()))
  return (d_grads, g_grads), dict(
      d_loss=d_loss.detach(), g_loss=g_loss.detach(),
      c_loss_d=c_loss_d.detach(), c_loss_g=c_loss_g.detach(),
      c_loss_g_pretrained=c_loss_g_pretrained.detach())


def train_g_d(state: TrainState, batch: Batch, config,
              additional_data: Optional[Dict[str, Any]] = None,
              graphs=None) -> Dict[str, torch.Tensor]:
  """Joint G+D update on one (global) sub-batch; updates ``state`` in
  place and returns the five losses (means over the microbatches).
  ``graphs``: the state's `engine.graphed.StepGraphs`, or None for the
  eager update."""
  additional_data = additional_data or {}
  g_net, d_net = state.generator, state.discriminator
  with tracing.span("gd_update"):
    g_net.train()
    d_net.train()
    (d_grads, g_grads), loss_values = _update_grads(
        "joint", lambda mb: _joint_grads(state, mb, config, additional_data),
        batch, config, graphs,
        tuple(additional_data[k] for k in sorted(additional_data)))
    _apply(state.d_opt, list(d_net.parameters()), d_grads)
    _apply(state.g_opt, list(g_net.parameters()), g_grads)

    decay = config.polyak_decay
    with tracing.span("ema"), torch.no_grad():
      for name, p in g_net.named_parameters():
        ema = state.ema_params[name]
        ema.mul_(decay).add_(p, alpha=1.0 - decay)
  state.step += 1
  return loss_values


def _critic_grads(state: TrainState, batch: Batch):
  """``((d_grads,), {})`` of the critic update on one (micro)batch."""
  g_net, d_net = state.generator, state.discriminator
  with tracing.span("forward"):
    with torch.no_grad(), frozen_state(g_net):
      fake_image = g_net(batch, _noise(batch, g_net.dtype))
    all_images = torch.cat([image_to_float(batch["image"]),
                            fake_image.float()])
    logit, stats = d_net(all_images, batch, critic_only=True)
    real_logit, fake_logit = _global_logits(logit)
    c_loss_d, _ = contrastive_totals(stats)
    d_loss = losses.hinge_d(real_logit, fake_logit) + c_loss_d
  with tracing.span("backward"):
    return (_grads(d_loss, list(d_net.parameters())),), {}


def train_d(state: TrainState, batch: Batch, config, graphs=None) -> None:
  """Discriminator-only update (an extra critic step), in place.

  G runs forward in train mode without writing its state, neither its
  running statistics nor (with ``g_spectral_norm``) its ``u0``, for every
  microbatch, as the JAX critic step discards G's new collections; D's
  spectral-norm state advances.  ``graphs`` as in `train_g_d`.
  """
  with tracing.span("d_update"):
    state.generator.train()
    state.discriminator.train()
    (d_grads,), _ = _update_grads(
        "critic", lambda mb: _critic_grads(state, mb), batch, config, graphs)
    _apply(state.d_opt, list(state.discriminator.parameters()), d_grads)

"""Train state (the JAX package's ``engine/state.py``).

The state holds the two networks, their Adam optimizers, the EMA of the
generator's parameters and the outer step count.  Unlike the JAX pytree
it is updated in place.  The learning rates are constant or follow the
JAX package's ``cosine`` and ``linear`` schedules (`learning_rates`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from xmcgan_image_generation_tpu_torch.models import get_architecture
from xmcgan_image_generation_tpu_torch.parallel import collectives


@dataclasses.dataclass
class TrainState:
  """Training state.

  Attributes:
    step: Outer train steps taken.
    generator / discriminator: The networks; their buffers are the JAX
      ``batch_stats`` (G) and ``spectral_norm_stats`` (D).
    g_opt / d_opt: Adam over each network's parameters.
    ema_params: Polyak average of the generator's named parameters.
    graphs: The updates' CUDA graphs (`engine.graphed.StepGraphs`), made
      at the first step that takes them; None on the eager path.
  """

  step: int
  generator: nn.Module
  discriminator: nn.Module
  g_opt: ScheduledAdam
  d_opt: ScheduledAdam
  ema_params: Dict[str, torch.Tensor]
  graphs: Any = dataclasses.field(default=None, repr=False, compare=False)


Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
  """``optax.linear_schedule(init, end, steps)``."""
  if steps <= 0:
    return lambda count: init
  return lambda count: (init - end) * (1 - min(max(count, 0), steps)
                                       / steps) + end


def _cosine(init: float, steps: int) -> Schedule:
  """``optax.cosine_decay_schedule(init, steps)`` (to 0)."""
  if steps <= 0:
    raise ValueError(f"the cosine decay needs steps > 0, got {steps}")
  return lambda count: init * 0.5 * (
      1 + math.cos(math.pi * min(count, steps) / steps))


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
  """``optax.join_schedules([first, second], [boundary])``."""
  return lambda count: (first(count) if count < boundary
                        else second(count - boundary))


def _learning_rate(config, base: float,
                   opt_steps_per_train_step: int = 1
                   ) -> Union[float, Schedule]:
  """The learning rate of one optimizer: ``base`` for the constant
  default; for ``cosine`` (linear warmup to ``base``, cosine decay to 0)
  and ``linear`` (linear warmup, linear decay to 0) a function of the
  optimizer's update count.  ``lr_warmup_steps`` and ``lr_decay_steps``
  count outer steps; the discriminator updates ``d_step_per_g_step``
  times per outer step, so its schedule is stretched by that factor."""
  sched = config.get("lr_schedule", "constant")
  if sched == "constant":
    return base
  raw_warmup = int(config.get("lr_warmup_steps", 0))
  raw_decay = int(config.get("lr_decay_steps", 0))
  if raw_decay <= 0:
    raise ValueError(
        "lr_schedule != 'constant' requires lr_decay_steps > 0 "
        "(num_train_steps may be epoch-derived and unknown statically)")
  if raw_warmup >= raw_decay:
    raise ValueError(f"lr_warmup_steps ({raw_warmup}) must be < "
                     f"lr_decay_steps ({raw_decay})")
  warmup = raw_warmup * opt_steps_per_train_step
  decay = raw_decay * opt_steps_per_train_step
  if sched == "cosine":
    return _join(_linear(0.0, base, warmup), _cosine(base, decay - warmup),
                 warmup)
  if sched == "linear":
    return _join(_linear(0.0, base, max(warmup, 1)),
                 _linear(base, 0.0, decay - warmup), warmup)
  raise ValueError(f"Unknown lr_schedule: {sched!r}")


def learning_rates(config) -> Tuple[Union[float, Schedule],
                                    Union[float, Schedule]]:
  """The (G, D) learning rates: floats when constant, else functions of
  the optimizer's update count.  Evaluate D's at ``outer_step *
  d_step_per_g_step``."""
  return (_learning_rate(config, config.g_lr),
          _learning_rate(config, config.d_lr,
                         int(config.get("d_step_per_g_step", 1))))


class ScheduledAdam(torch.optim.Adam):
  """Adam whose learning rate, when ``schedule`` is given, is
  ``schedule(count)`` at each update, ``count`` being the updates before
  it: the first update takes the schedule's value at 0, as
  ``optax.adam(schedule)`` does.  The count lives in the parameter group
  (``lr_count``), so the optimizer's ``state_dict`` and the checkpoint
  carry it."""

  def __init__(self, params, schedule: Optional[Schedule] = None, **kw):
    super().__init__(params, lr=schedule(0) if schedule else kw.pop("lr"),
                     **kw)
    self.schedule = schedule
    for group in self.param_groups:
      group["lr_count"] = 0

  @torch.no_grad()
  def step(self, closure=None):
    if self.schedule is not None:
      for group in self.param_groups:
        group["lr"] = self.schedule(group["lr_count"])
        group["lr_count"] += 1
    return super().step(closure)


def create_optimizers(config, generator: nn.Module, discriminator: nn.Module
                      ) -> Tuple[ScheduledAdam, ScheduledAdam]:
  """Adam with betas (beta1, beta2), eps 1e-8 and the rates of
  `learning_rates`; ``torch.optim.Adam`` computes the update of
  ``optax.adam``."""
  betas = (config.beta1, config.beta2)
  opts = []
  for module, lr in zip((generator, discriminator), learning_rates(config)):
    if callable(lr):
      opts.append(ScheduledAdam(module.parameters(), schedule=lr,
                                betas=betas, eps=1e-8))
    else:
      opts.append(ScheduledAdam(module.parameters(), lr=lr, betas=betas,
                                eps=1e-8))
  return opts[0], opts[1]


def create_train_state(config, device, seed: int = 0) -> TrainState:
  """Randomly initialized networks (flax-style init, from ``seed``),
  fresh optimizers, and the EMA as a copy of G's parameters."""
  gen_cls, disc_cls = get_architecture(config)
  g_rng = torch.Generator().manual_seed(seed)
  d_rng = torch.Generator().manual_seed(seed + 1)
  generator = gen_cls(config, device=device, generator=g_rng)
  discriminator = disc_cls(config, device=device, generator=d_rng)
  g_opt, d_opt = create_optimizers(config, generator, discriminator)
  ema = {name: p.detach().clone()
         for name, p in generator.named_parameters()}
  return TrainState(step=0, generator=generator, discriminator=discriminator,
                    g_opt=g_opt, d_opt=d_opt, ema_params=ema)


def broadcast_state(state: TrainState, src: int = 0) -> None:
  """Overwrites ``state`` on every process of the ambient process group
  with process ``src``'s: parameters, BatchNorm statistics, spectral-norm
  ``u0``, the EMA and the Adam slots and counts, so that the replicas
  start identical after creation or a restore.  No-op without a group."""
  tensors = []
  for module in (state.generator, state.discriminator):
    tensors += list(module.parameters()) + list(module.buffers())
  tensors += list(state.ema_params.values())
  for opt in (state.g_opt, state.d_opt):
    for slots in opt.state.values():
      tensors += [v for v in slots.values() if torch.is_tensor(v)]
  collectives.broadcast_(tensors, src=src)

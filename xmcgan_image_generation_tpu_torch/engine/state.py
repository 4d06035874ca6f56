"""Train state (the JAX package's ``engine/state.py``).

The state holds the two networks, their Adam optimizers, the EMA of the
generator's parameters and the outer step count.  Unlike the JAX pytree
it is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from xmcgan_image_generation_tpu_torch.models import get_architecture


@dataclasses.dataclass
class TrainState:
  """Training state.

  Attributes:
    step: Outer train steps taken.
    generator / discriminator: The networks; their buffers are the JAX
      ``batch_stats`` (G) and ``spectral_norm_stats`` (D).
    g_opt / d_opt: Adam over each network's parameters.
    ema_params: Polyak average of the generator's named parameters.
  """

  step: int
  generator: nn.Module
  discriminator: nn.Module
  g_opt: torch.optim.Adam
  d_opt: torch.optim.Adam
  ema_params: Dict[str, torch.Tensor]


def create_optimizers(config, generator: nn.Module, discriminator: nn.Module
                      ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
  """Adam with betas (beta1, beta2), eps 1e-8 and the constant rates
  lr G / lr D; ``torch.optim.Adam`` computes the update of ``optax.adam``.
  """
  if config.get("lr_schedule", "constant") != "constant":
    raise NotImplementedError("learning-rate schedules are not ported yet")
  betas = (config.beta1, config.beta2)
  g_opt = torch.optim.Adam(generator.parameters(), lr=config.g_lr,
                           betas=betas, eps=1e-8)
  d_opt = torch.optim.Adam(discriminator.parameters(), lr=config.d_lr,
                           betas=betas, eps=1e-8)
  return g_opt, d_opt


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

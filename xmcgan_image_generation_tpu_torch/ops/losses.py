"""GAN loss primitives (the JAX package's ``ops/losses.py``).

Every loss is taken in float32 whatever the network's compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def hinge_g(fake_logit: torch.Tensor) -> torch.Tensor:
  """Generator hinge loss: maximize D(fake)."""
  return -fake_logit.float().mean()


def hinge_d(real_logit: torch.Tensor,
            fake_logit: torch.Tensor) -> torch.Tensor:
  """Discriminator hinge loss."""
  real_loss = F.relu(1.0 - real_logit.float()).mean()
  fake_loss = F.relu(1.0 + fake_logit.float()).mean()
  return real_loss + fake_loss


def hinge(real_logit: torch.Tensor, fake_logit: torch.Tensor):
  """Joint hinge loss, returns ``(d_loss, g_loss)``."""
  return hinge_d(real_logit, fake_logit), hinge_g(fake_logit)


def softmax_cross_entropy(*, labels: torch.Tensor,
                          logits: torch.Tensor) -> torch.Tensor:
  """Dense-label softmax cross entropy, per row."""
  logp = F.log_softmax(logits.float(), dim=-1)
  return -(labels * logp).sum(dim=-1)

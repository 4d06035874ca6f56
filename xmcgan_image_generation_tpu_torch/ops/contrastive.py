"""Cross-modal contrastive (NT-Xent / InfoNCE) loss.

The JAX package's ``ops/contrastive.py``: the negative pool is the global
batch.  With an ambient process group (`parallel.context`) each process
passes its rows, both feature sets are gathered
(`parallel.collectives.all_gather`), and every process computes the same
loss on the whole batch, as JAX's ``pallas_call`` runs replicated under
GSPMD.  Features are promoted to float32 before normalization.  With
``use_pallas`` the whole l2norm -> similarity -> bidirectional CE
pipeline runs as one fused op, `ops.cuda.ntxent.nt_xent_fused` (a CUDA
kernel for tensors on the card).  ``group_size > 0`` pools the negatives
within contiguous groups of that many examples of the global batch (the
einsum form, as in JAX).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from xmcgan_image_generation_tpu_torch.ops import losses
from xmcgan_image_generation_tpu_torch.parallel import collectives


def l2_normalize(x: torch.Tensor, dim=-1,
                 epsilon: float = 1e-12) -> torch.Tensor:
  """``x * rsqrt(max(sum(x^2), eps))``: the max-clamped denominator."""
  square_sum = (x * x).sum(dim=dim, keepdim=True)
  return x * torch.rsqrt(torch.clamp_min(square_sum, epsilon))


def logit_statistics(logits: torch.Tensor, labels: torch.Tensor):
  """Diagnostics: top-1 accuracy and prediction entropy."""
  prob = F.softmax(logits, dim=-1)
  entropy = -(prob * torch.log(prob + 1e-8)).sum(dim=-1).mean()
  acc = logits.argmax(dim=-1) == labels.argmax(dim=-1)
  return acc.float().mean(), entropy


def nt_xent(
    feat_a: torch.Tensor,
    feat_b: torch.Tensor,
    *,
    l2_norm: bool = True,
    temperature: float = 0.1,
    use_pallas: bool = False,
    group_size: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Symmetric InfoNCE between two aligned ``[batch, dim]`` feature sets
  (this process's rows under a process group).

  Returns ``(loss, accuracy, entropy)`` scalars; ``loss`` is the sum of the
  two directional cross entropies.  The fused op counts a tie with the
  diagonal as a correct prediction; the einsum form here takes argmax,
  which differs only on exact ties.  ``group_size > 0``: the means over
  contiguous groups of that many examples.
  """
  feat_a = collectives.all_gather(feat_a, tag="contrastive")
  feat_b = collectives.all_gather(feat_b, tag="contrastive")
  if group_size and group_size > 0:
    batch = feat_a.shape[0]
    if batch % group_size:
      raise ValueError(f"batch {batch} not divisible by contrastive "
                       f"group_size={group_size}")
    per_group = [_nt_xent(a, b, l2_norm, temperature) for a, b in zip(
        feat_a.split(group_size), feat_b.split(group_size))]
    return tuple(torch.stack(v).mean() for v in zip(*per_group))
  if use_pallas and l2_norm:
    from xmcgan_image_generation_tpu_torch.ops.cuda.ntxent import (
        nt_xent_fused,
    )
    return nt_xent_fused(feat_a, feat_b, temperature)
  return _nt_xent(feat_a, feat_b, l2_norm, temperature)


def _nt_xent(feat_a: torch.Tensor, feat_b: torch.Tensor, l2_norm: bool,
             temperature: float):
  """The einsum form on whole (gathered) feature sets."""
  feat_a = feat_a.float()
  feat_b = feat_b.float()
  if l2_norm:
    feat_a = l2_normalize(feat_a, dim=-1)
    feat_b = l2_normalize(feat_b, dim=-1)
  batch = feat_a.shape[0]
  labels = torch.eye(batch, dtype=torch.float32, device=feat_a.device)
  logits_ab = (feat_a @ feat_b.t()) / temperature
  logits_ba = logits_ab.t()
  loss_ab = losses.softmax_cross_entropy(labels=labels,
                                         logits=logits_ab).mean()
  loss_ba = losses.softmax_cross_entropy(labels=labels,
                                         logits=logits_ba).mean()
  acc_ab, ent_ab = logit_statistics(logits_ab, labels)
  acc_ba, ent_ba = logit_statistics(logits_ba, labels)
  return loss_ab + loss_ba, 0.5 * (acc_ab + acc_ba), 0.5 * (ent_ab + ent_ba)

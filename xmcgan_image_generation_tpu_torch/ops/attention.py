"""Region-word attention and the AttnGAN-style word matching loss.

The JAX package's ``ops/attention.py`` on one device.  Softmax,
logsumexp and normalization run in float32; masked positions take an
additive ``-1e9``.  With ``use_pallas`` the caption x image score matrix
comes from `ops.cuda.word_scores.word_scores` (CUDA kernels for tensors on
the card) instead of the einsum form, which materializes ``[B, B, R, L]``
and ``[B, B, L, D]`` tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from xmcgan_image_generation_tpu_torch.ops import losses
from xmcgan_image_generation_tpu_torch.ops.contrastive import (
    l2_normalize,
    logit_statistics,
)

NEG_INF = -1e9


def padding_mask(max_len: torch.Tensor, total_len: int) -> torch.Tensor:
  """``[batch, total_len]`` float mask, 1.0 at padding word positions."""
  max_len = max_len.reshape(-1, 1).float()
  positions = torch.arange(total_len, dtype=torch.float32,
                           device=max_len.device)[None, :]
  return (positions >= max_len).float()


def attention_for_g(
    region_feat: torch.Tensor,
    word_feat: torch.Tensor,
    gamma: float,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Word context for each image region (generator side).

  ``region_feat`` ``[B, R, D]``, ``word_feat`` ``[B, L, D]``, ``mask``
  ``[B, L]`` with 1.0 at padding.  Returns ``(region_context [B, R, D],
  attn [B, R, L])``.
  """
  rn = l2_normalize(region_feat.float(), dim=-1)
  wn = l2_normalize(word_feat.float(), dim=-1)
  logits = torch.einsum("brd,bwd->brw", rn, wn) * gamma
  if mask is not None:
    if mask.dim() == 2:
      mask = mask[:, None, :]
    logits = logits + mask.float() * NEG_INF
  attn = F.softmax(logits, dim=-1)
  region_context = torch.einsum("brw,bwd->brd", attn, wn)
  return region_context, attn


def word_loss(
    region_feat: torch.Tensor,
    word_feat: torch.Tensor,
    max_len: torch.Tensor,
    gamma1: float = 5.0,
    gamma2: float = 5.0,
    gamma3: float = 50.0,
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """AttnGAN word-region matching loss over the batch.

  ``region_feat`` ``[B, R, D]``, ``word_feat`` ``[B, L, D]``, ``max_len``
  ``[B]`` or ``[B, 1]``.  Returns ``(loss, accuracy, entropy)`` scalars.
  """
  total_len = word_feat.shape[1]
  mask = padding_mask(max_len, total_len)

  if use_pallas:
    from xmcgan_image_generation_tpu_torch.ops.cuda.word_scores import (
        word_scores,
    )
    scores_ji = word_scores(region_feat, word_feat, mask, gamma1,
                            gamma2) * gamma3
    return _word_loss_from_scores(scores_ji)

  rn = l2_normalize(region_feat.float(), dim=-1)
  wn = l2_normalize(word_feat.float(), dim=-1)
  # sim[j, i, r, w] = <region r of image i, word w of caption j>.
  sim = torch.einsum("ird,jwd->jirw", rn, wn)
  attn_logits = sim * gamma1 + mask[:, None, None, :] * NEG_INF
  alpha = F.softmax(attn_logits, dim=2)
  context = torch.einsum("jirw,ird->jiwd", alpha, rn)
  num = torch.einsum("jiwd,jwd->jiw", context, wn)
  ctx_sq = (context * context).sum(dim=-1)
  row_sim = num * torch.rsqrt(torch.clamp_min(ctx_sq, 1e-12))
  row_sim = row_sim * gamma2 + mask[:, None, :] * NEG_INF
  scores_ji = torch.logsumexp(row_sim, dim=-1) / gamma2  # [caption, image]
  return _word_loss_from_scores(scores_ji * gamma3)


def _word_loss_from_scores(scores_ji: torch.Tensor):
  """Symmetric CE + stats on the [caption, image] score matrix."""
  batch = scores_ji.shape[0]
  scores_ij = scores_ji.t()
  labels = torch.eye(batch, dtype=torch.float32, device=scores_ji.device)
  loss_i2c = losses.softmax_cross_entropy(labels=labels,
                                          logits=scores_ij).mean()
  loss_c2i = losses.softmax_cross_entropy(labels=labels,
                                          logits=scores_ji).mean()
  acc_ij, ent_ij = logit_statistics(scores_ij, labels)
  acc_ji, ent_ji = logit_statistics(scores_ji, labels)
  return (loss_i2c + loss_c2i, 0.5 * (acc_ij + acc_ji),
          0.5 * (ent_ij + ent_ji))

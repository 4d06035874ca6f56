"""Region-word attention and the AttnGAN-style word matching loss.

The JAX package's ``ops/attention.py``.  Softmax, logsumexp and
normalization run in float32; masked positions take an additive ``-1e9``.
With ``use_pallas`` the caption x image score matrix comes from
`ops.cuda.word_scores.word_scores` (CUDA kernels for tensors on the card)
instead of the einsum form, which materializes ``[B, B, R, L]`` and ``[B,
B, L, D]`` tensors.

`word_loss` matches over the global batch.  With an ambient process group
(`parallel.context`) each process passes its rows; with ``use_pallas``
and more than one process the scores come from
`ops.cuda.word_scores.make_sharded_word_scores` (each process scores its
images against every caption), as JAX's dispatch picks
``make_sharded_word_scores`` on a ``data`` mesh; otherwise the inputs are
gathered and every process computes the whole matrix.
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
from xmcgan_image_generation_tpu_torch.parallel import collectives
from xmcgan_image_generation_tpu_torch.parallel import context

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
    group_size: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """AttnGAN word-region matching loss over the global batch.

  ``region_feat`` ``[B, R, D]``, ``word_feat`` ``[B, L, D]``, ``max_len``
  ``[B]`` or ``[B, 1]`` (this process's rows under a process group).
  Returns ``(loss, accuracy, entropy)`` scalars.  ``group_size > 0``
  matches within contiguous groups of that many examples (the einsum
  form, as in JAX) and returns the groups' means.
  """
  if group_size and group_size > 0:
    region_feat, word_feat, max_len = _gathered(region_feat, word_feat,
                                                max_len)
    batch = region_feat.shape[0]
    if batch % group_size:
      raise ValueError(f"batch {batch} not divisible by contrastive "
                       f"group_size={group_size}")
    per_group = [
        _word_loss_einsum(r, w, m, gamma1, gamma2, gamma3) for r, w, m in
        zip(region_feat.split(group_size), word_feat.split(group_size),
            max_len.reshape(batch, -1).split(group_size))]
    return tuple(torch.stack(v).mean() for v in zip(*per_group))

  if use_pallas:
    from xmcgan_image_generation_tpu_torch.ops.cuda.word_scores import (
        word_scores,
    )
    # Under a process group every process holds as many rows, so the
    # global batch divides by the world size: the sharded dispatch.
    mask = padding_mask(max_len, word_feat.shape[1])
    scores_ji = word_scores(region_feat, word_feat, mask, gamma1, gamma2,
                            mesh=context.active_mesh()) * gamma3
    return _word_loss_from_scores(scores_ji)
  return _word_loss_einsum(*_gathered(region_feat, word_feat, max_len),
                           gamma1, gamma2, gamma3)


def _gathered(region_feat, word_feat, max_len):
  """Every process's rows of the three inputs (the regions with
  autograd); the inputs themselves without a process group."""
  return (collectives.all_gather(region_feat, tag="word_regions"),
          collectives.all_gather(word_feat, tag="word_features"),
          collectives.gather_rows(max_len, tag="word_lengths"))


def _word_loss_einsum(region_feat, word_feat, max_len, gamma1, gamma2,
                      gamma3):
  """The einsum form on whole (gathered) inputs."""
  mask = padding_mask(max_len, word_feat.shape[1])
  rn = l2_normalize(region_feat.float(), dim=-1)
  wn = l2_normalize(word_feat.float(), dim=-1)
  # sim[j, i, r, w] = <region r of image i, word w of caption j>.
  sim = torch.einsum("ird,jwd->jirw", rn, wn)
  attn_logits = sim * gamma1 + mask[:, None, None, :] * NEG_INF
  alpha = F.softmax(attn_logits, dim=2)
  ctx = torch.einsum("jirw,ird->jiwd", alpha, rn)
  num = torch.einsum("jiwd,jwd->jiw", ctx, wn)
  ctx_sq = (ctx * ctx).sum(dim=-1)
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

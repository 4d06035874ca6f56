"""Scale-fused convolutions (the JAX package's ``ops/scale_fuse.py``).

``conv3x3(nearest_upsample_2x(x))`` and ``avg_pool_2x2(conv3x3(x))`` each
factor exactly into one conv with a 4x4 kernel built from the 3x3 one.
Here the tensors are NCHW and the kernels OIHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pool_combos(w: torch.Tensor, dim: int) -> torch.Tensor:
  """3-tap kernel axis -> the 4-tap pooled-conv combination."""
  w0, w1, w2 = (w.narrow(dim, i, 1) for i in range(3))
  return torch.cat([w0, w0 + w1, w1 + w2, w2], dim=dim)


def fuse_pool_kernel(w: torch.Tensor) -> torch.Tensor:
  """``[co, ci, 3, 3]`` -> ``[co, ci, 4, 4]`` kernel of the pool-fused conv."""
  return _pool_combos(_pool_combos(w, 2), 3) * 0.25


def upsample_conv_dilated(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """``conv3x3_SAME(nearest_upsample_2x(x), w)`` as one conv.

  The JAX op convolves the base-2-dilated input with the 4x4 kernel
  ``K = 4 fuse_pool_kernel(w)`` at padding 2.  That is the transposed
  conv of ``x`` with the flipped ``K`` at stride 2 and padding 1.
  ``x`` is ``[B, ci, H, W]``; returns ``[B, co, 2H, 2W]``.
  """
  k = _pool_combos(_pool_combos(w, 2), 3)
  return F.conv_transpose2d(x, k.flip(2, 3).transpose(0, 1), stride=2,
                            padding=1)


def conv_pool(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """``avg_pool_2x2_s2(conv3x3_SAME(x, w))`` as one stride-2 conv."""
  if x.shape[2] % 2 or x.shape[3] % 2:
    raise ValueError(f"conv_pool needs even spatial dims, got {x.shape}")
  return F.conv2d(x, fuse_pool_kernel(w), stride=2, padding=1)

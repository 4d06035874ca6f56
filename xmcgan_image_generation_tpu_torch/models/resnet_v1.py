"""ResNet V1 feature tower (the JAX package's ``models/resnet_v1.py``):
the generic `ResNet` with `BottleneckBlock`, and `ResNet50`.

Takes and returns NHWC tensors; runs NCHW inside.  Convolutions pad as
TF "SAME" does, which is asymmetric at stride 2 (the 7x7/2 stem on 224
pads (2, 3), a 3x3/2 conv (0, 1)); the 3x3/2 max pool pads with -inf.
Golden size: ResNet-50 has 25,557,032 parameters at 1000 classes.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from xmcgan_image_generation_tpu_torch.ops.normalization import BatchNorm
from xmcgan_image_generation_tpu_torch.ops.spectral_norm import (
    Conv,
    Dense,
    same_padding,
)


class BottleneckBlock(nn.Module):
  """1x1 -> 3x3 -> 1x1 bottleneck with a projection where shapes change."""

  def __init__(self, in_features: int, filters: int,
               strides: Tuple[int, int] = (1, 1), *, dtype, device=None,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    conv = functools.partial(Conv, use_bias=False, kernel_init="lecun_normal",
                             dtype=dtype, device=device, generator=generator)
    norm = functools.partial(BatchNorm, use_scale=True, use_bias=True,
                             dtype=dtype, device=device)
    self.conv1 = conv(in_features, filters, (1, 1))
    self.bn1 = norm(filters)
    self.conv2 = conv(filters, filters, (3, 3), strides=strides)
    self.bn2 = norm(filters)
    self.conv3 = conv(filters, 4 * filters, (1, 1))
    self.bn3 = norm(4 * filters)
    self.has_projection = (in_features != 4 * filters
                           or tuple(strides) != (1, 1))
    if self.has_projection:
      self.proj_conv = conv(in_features, 4 * filters, (1, 1),
                            strides=strides)
      self.proj_bn = norm(4 * filters)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    residual = x
    y = F.relu(self.bn1(self.conv1(x)))
    y = F.relu(self.bn2(self.conv2(y)))
    y = self.bn3(self.conv3(y))
    if self.has_projection:
      residual = self.proj_bn(self.proj_conv(residual))
    return F.relu(residual + y)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
  """TF "SAME" max pool: pads with -inf, asymmetrically where needed."""
  (pt, pb), (pl, pr) = (same_padding(x.shape[2], window, stride),
                        same_padding(x.shape[3], window, stride))
  x = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
  return F.max_pool2d(x, window, stride)


class ResNet(nn.Module):
  """ResNet V1 returning ``(spatial_features NHWC, logits)``.

  Names follow flax: ``init_conv``, ``init_bn``, ``stage{i}_block{j}``,
  ``head`` (zero-initialized).
  """

  def __init__(self, num_classes: int, stage_sizes: Sequence[int],
               width_factor: int = 1, *, dtype=torch.float32, device=None,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.dtype = dtype
    width = 64 * width_factor
    self.init_conv = Conv(3, width, (7, 7), strides=(2, 2), use_bias=False,
                          kernel_init="lecun_normal", dtype=dtype,
                          device=device, generator=generator)
    self.init_bn = BatchNorm(width, use_scale=True, use_bias=True,
                             dtype=dtype, device=device)
    in_ch = width
    self.stages = []
    for i, stage_size in enumerate(stage_sizes):
      for j in range(stage_size):
        strides = (2, 2) if i > 0 and j == 0 else (1, 1)
        block = BottleneckBlock(in_ch, width * 2**i, strides, dtype=dtype,
                                device=device, generator=generator)
        self.add_module(f"stage{i + 1}_block{j + 1}", block)
        self.stages.append(block)
        in_ch = 4 * width * 2**i
    self.head = Dense(in_ch, num_classes, kernel_init="zeros", dtype=dtype,
                      device=device, generator=generator)

  def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x.permute(0, 3, 1, 2).to(self.dtype)
    # As in the JAX tower, no activation between init_bn and the pool.
    x = self.init_bn(self.init_conv(x))
    x = max_pool_same(x, 3, 2)
    for block in self.stages:
      x = block(x)
    out = self.head(x.mean(dim=(2, 3)))
    return x.permute(0, 2, 3, 1), out


ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3])

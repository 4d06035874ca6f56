"""InceptionV3 for FID and Inception Score (the JAX package's
``models/inception_v3.py``).

Returns the 2048-d pool feature and the 1000-way logits.  Module names
follow the JAX module's Keras ``mixedN`` scheme (``mixed0.b1_5x5.conv``),
so `utils.bridge` maps the JAX package's converted weights onto it by
name.  Takes NHWC images in ``[-1, 1]`` and runs NCHW inside.  The 3x3
average pools inside the blocks use TF SAME semantics (padding cells
excluded from the mean, `ops.pooling.tf_avg_pool`).  Runs in eval mode:
BatchNorm uses its running statistics.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from xmcgan_image_generation_tpu_torch.ops.normalization import BatchNorm
from xmcgan_image_generation_tpu_torch.ops.pooling import tf_avg_pool
from xmcgan_image_generation_tpu_torch.ops.spectral_norm import Conv, Dense


class ConvBN(nn.Module):
  """Conv -> BatchNorm (no scale, eps 1e-3) -> ReLU, Keras style."""

  def __init__(self, in_features: int, features: int,
               kernel_size: Sequence[int], strides=(1, 1),
               padding: str = "SAME", *, device=None,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.conv = Conv(in_features, features, kernel_size, strides=strides,
                     padding=padding, use_bias=False,
                     kernel_init="lecun_normal", device=device,
                     generator=generator)
    self.bn = BatchNorm(features, momentum=0.99, epsilon=1e-3,
                        use_bias=True, device=device)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
  return tf_avg_pool(x, (3, 3), (1, 1), "SAME")


def _max_pool(x: torch.Tensor) -> torch.Tensor:
  return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
  """A block whose branches are built by name: ``cbn(name, in, out,
  kernel, ...)`` adds a `ConvBN` called ``name``."""

  def __init__(self, device, generator):
    super().__init__()
    self._cbn = functools.partial(ConvBN, device=device, generator=generator)

  def cbn(self, name, *args, **kwargs) -> ConvBN:
    module = self._cbn(*args, **kwargs)
    self.add_module(name, module)
    return module


class InceptionA(_Block):
  """35x35 block (mixed0/1/2): 1x1, 5x5, double-3x3 and pool branches."""

  def __init__(self, in_features: int, pool_features: int, *, device=None,
               generator=None):
    super().__init__(device, generator)
    self.cbn("b0_1x1", in_features, 64, (1, 1))
    self.cbn("b1_1x1", in_features, 48, (1, 1))
    self.cbn("b1_5x5", 48, 64, (5, 5))
    self.cbn("b2_1x1", in_features, 64, (1, 1))
    self.cbn("b2_3x3a", 64, 96, (3, 3))
    self.cbn("b2_3x3b", 96, 96, (3, 3))
    self.cbn("b3_1x1", in_features, pool_features, (1, 1))
    self.features = 64 + 64 + 96 + pool_features

  def forward(self, x):
    b0 = self.b0_1x1(x)
    b1 = self.b1_5x5(self.b1_1x1(x))
    b2 = self.b2_3x3b(self.b2_3x3a(self.b2_1x1(x)))
    b3 = self.b3_1x1(_avg_pool_3x3_same(x))
    return torch.cat([b0, b1, b2, b3], dim=1)


class InceptionB(_Block):
  """Reduction block to 17x17 (mixed3)."""

  def __init__(self, in_features: int, *, device=None, generator=None):
    super().__init__(device, generator)
    self.cbn("b0_3x3", in_features, 384, (3, 3), (2, 2), "VALID")
    self.cbn("b1_1x1", in_features, 64, (1, 1))
    self.cbn("b1_3x3a", 64, 96, (3, 3))
    self.cbn("b1_3x3b", 96, 96, (3, 3), (2, 2), "VALID")
    self.features = 384 + 96 + in_features

  def forward(self, x):
    b0 = self.b0_3x3(x)
    b1 = self.b1_3x3b(self.b1_3x3a(self.b1_1x1(x)))
    return torch.cat([b0, b1, _max_pool(x)], dim=1)


class InceptionC(_Block):
  """17x17 block with 7x1/1x7 factorized convs (mixed4..7)."""

  def __init__(self, in_features: int, mid_channels: int, *, device=None,
               generator=None):
    super().__init__(device, generator)
    c = mid_channels
    self.cbn("b0_1x1", in_features, 192, (1, 1))
    self.cbn("b1_1x1", in_features, c, (1, 1))
    self.cbn("b1_1x7", c, c, (1, 7))
    self.cbn("b1_7x1", c, 192, (7, 1))
    self.cbn("b2_1x1", in_features, c, (1, 1))
    self.cbn("b2_7x1a", c, c, (7, 1))
    self.cbn("b2_1x7a", c, c, (1, 7))
    self.cbn("b2_7x1b", c, c, (7, 1))
    self.cbn("b2_1x7b", c, 192, (1, 7))
    self.cbn("b3_1x1", in_features, 192, (1, 1))
    self.features = 4 * 192

  def forward(self, x):
    b0 = self.b0_1x1(x)
    b1 = self.b1_7x1(self.b1_1x7(self.b1_1x1(x)))
    b2 = self.b2_1x1(x)
    for name in ("b2_7x1a", "b2_1x7a", "b2_7x1b", "b2_1x7b"):
      b2 = getattr(self, name)(b2)
    b3 = self.b3_1x1(_avg_pool_3x3_same(x))
    return torch.cat([b0, b1, b2, b3], dim=1)


class InceptionD(_Block):
  """Reduction block to 8x8 (mixed8)."""

  def __init__(self, in_features: int, *, device=None, generator=None):
    super().__init__(device, generator)
    self.cbn("b0_1x1", in_features, 192, (1, 1))
    self.cbn("b0_3x3", 192, 320, (3, 3), (2, 2), "VALID")
    self.cbn("b1_1x1", in_features, 192, (1, 1))
    self.cbn("b1_1x7", 192, 192, (1, 7))
    self.cbn("b1_7x1", 192, 192, (7, 1))
    self.cbn("b1_3x3", 192, 192, (3, 3), (2, 2), "VALID")
    self.features = 320 + 192 + in_features

  def forward(self, x):
    b0 = self.b0_3x3(self.b0_1x1(x))
    b1 = self.b1_1x1(x)
    for name in ("b1_1x7", "b1_7x1", "b1_3x3"):
      b1 = getattr(self, name)(b1)
    return torch.cat([b0, b1, _max_pool(x)], dim=1)


class InceptionE(_Block):
  """8x8 block with split 1x3/3x1 branches (mixed9/10)."""

  def __init__(self, in_features: int, *, device=None, generator=None):
    super().__init__(device, generator)
    self.cbn("b0_1x1", in_features, 320, (1, 1))
    self.cbn("b1_1x1", in_features, 384, (1, 1))
    self.cbn("b1_1x3", 384, 384, (1, 3))
    self.cbn("b1_3x1", 384, 384, (3, 1))
    self.cbn("b2_1x1", in_features, 448, (1, 1))
    self.cbn("b2_3x3", 448, 384, (3, 3))
    self.cbn("b2_1x3", 384, 384, (1, 3))
    self.cbn("b2_3x1", 384, 384, (3, 1))
    self.cbn("b3_1x1", in_features, 192, (1, 1))
    self.features = 320 + 768 + 768 + 192

  def forward(self, x):
    b0 = self.b0_1x1(x)
    b1 = self.b1_1x1(x)
    b1 = torch.cat([self.b1_1x3(b1), self.b1_3x1(b1)], dim=1)
    b2 = self.b2_3x3(self.b2_1x1(x))
    b2 = torch.cat([self.b2_1x3(b2), self.b2_3x1(b2)], dim=1)
    b3 = self.b3_1x1(_avg_pool_3x3_same(x))
    return torch.cat([b0, b1, b2, b3], dim=1)


class InceptionV3(nn.Module):
  """The full network; expects NHWC 299x299 inputs in [-1, 1] (75x75 is
  the smallest size it takes).

  ``forward`` returns ``(pool [N, 2048], logits [N, num_classes])``.
  Float32 throughout.  Without a ``generator`` the weights are drawn from
  one seeded with 0, so a randomly initialized tower is the same in every
  run.
  """

  def __init__(self, num_classes: int = 1000, *, device=None,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    if generator is None:
      generator = torch.Generator().manual_seed(0)
    kw = dict(device=device, generator=generator)
    self.stem_conv0 = ConvBN(3, 32, (3, 3), (2, 2), "VALID", **kw)
    self.stem_conv1 = ConvBN(32, 32, (3, 3), padding="VALID", **kw)
    self.stem_conv2 = ConvBN(32, 64, (3, 3), **kw)
    self.stem_conv3 = ConvBN(64, 80, (1, 1), padding="VALID", **kw)
    self.stem_conv4 = ConvBN(80, 192, (3, 3), padding="VALID", **kw)
    blocks = []
    ch = 192
    for name, make in (
        ("mixed0", lambda c: InceptionA(c, 32, **kw)),
        ("mixed1", lambda c: InceptionA(c, 64, **kw)),
        ("mixed2", lambda c: InceptionA(c, 64, **kw)),
        ("mixed3", lambda c: InceptionB(c, **kw)),
        ("mixed4", lambda c: InceptionC(c, 128, **kw)),
        ("mixed5", lambda c: InceptionC(c, 160, **kw)),
        ("mixed6", lambda c: InceptionC(c, 160, **kw)),
        ("mixed7", lambda c: InceptionC(c, 192, **kw)),
        ("mixed8", lambda c: InceptionD(c, **kw)),
        ("mixed9", lambda c: InceptionE(c, **kw)),
        ("mixed10", lambda c: InceptionE(c, **kw))):
      block = make(ch)
      self.add_module(name, block)
      blocks.append(block)
      ch = block.features
    self.blocks = blocks
    self.predictions = Dense(ch, num_classes, kernel_init="lecun_normal",
                             **kw)

  def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x.float().permute(0, 3, 1, 2)
    x = self.stem_conv2(self.stem_conv1(self.stem_conv0(x)))
    x = self.stem_conv4(self.stem_conv3(_max_pool(x)))
    x = _max_pool(x)
    for block in self.blocks:
      x = block(x)
    pool = x.mean(dim=(2, 3))
    return pool, self.predictions(pool)

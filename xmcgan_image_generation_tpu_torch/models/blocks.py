"""Residual generator and discriminator blocks (the JAX package's
``models/blocks.py``), NCHW.

Sub-layers are named as flax names them (``Conv_0``, ``SpectralConv_1``,
``ConditionalBatchNorm_0``, ...).  ``scale_fuse`` folds each generator
upsample into the following 3x3 conv and each discriminator 2x2 pool into
the preceding one (`ops.scale_fuse`); the parameters are the same either
way.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from xmcgan_image_generation_tpu_torch.ops.normalization import (
    ConditionalBatchNorm,
    FusedSpatialModulation,
    LocalConditionalBatchNorm,
)
from xmcgan_image_generation_tpu_torch.ops.pooling import dsample, upsample
from xmcgan_image_generation_tpu_torch.ops.spectral_norm import Conv


def conv_prefix(spectral: bool) -> str:
  """flax scope-name prefix of a conv layer."""
  return "SpectralConv" if spectral else "Conv"


class _Convs(nn.Module):
  """A block whose convs are registered as ``<prefix>_<n>`` in order."""

  def _add_convs(self, prefix: str, convs) -> list:
    for n, conv in enumerate(convs):
      self.add_module(f"{prefix}_{n}", conv)
    return list(convs)


class DiscBlock(_Convs):
  """Pre-activation residual block with optional 2x downsample."""

  def __init__(self, in_features: int, filters: int, downsample: bool, *,
               spectral: bool, scale_fuse: bool, dtype, device=None,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    kw = dict(spectral=spectral, dtype=dtype, device=device,
              generator=generator)
    self.downsample = downsample
    self.scale_fuse = scale_fuse
    self.needs_projection = downsample or in_features != filters
    pool = "pool" if scale_fuse and downsample else "none"
    convs = [Conv(in_features, filters, (3, 3), **kw),
             Conv(filters, filters, (3, 3), scale_op=pool, **kw)]
    if self.needs_projection:
      convs.append(Conv(in_features, filters, (1, 1), **kw))
    self.convs = self._add_convs(conv_prefix(spectral), convs)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    shortcut = x
    x = self.convs[0](F.relu(x))
    x = self.convs[1](F.relu(x))
    if self.scale_fuse and self.downsample:
      # The pool is folded into convs[1]; pool the shortcut before its 1x1
      # projection (linear ops commute).
      shortcut = dsample(shortcut)
      if self.needs_projection:
        shortcut = self.convs[2](shortcut)
    else:
      if self.needs_projection:
        shortcut = self.convs[2](shortcut)
      if self.downsample:
        x = dsample(x)
        shortcut = dsample(shortcut)
    return x + shortcut


class DiscBlockDeep(nn.Module):
  """Bottleneck discriminator block (BigGAN-deep): 1x1 down to
  ``filters // bottleneck_ratio``, two 3x3, optional 2x downsample of
  both branches, 1x1 up; a shortcut that grows the channels concatenates
  a 1x1 conv of the input (``conv_sc``).  Not used by `xmc_net`."""

  def __init__(self, in_features: int, filters: int, downsample: bool, *,
               spectral: bool, dtype, bottleneck_ratio: int = 4,
               device=None, generator: Optional[torch.Generator] = None):
    super().__init__()
    kw = dict(spectral=spectral, dtype=dtype, device=device,
              generator=generator)
    hidden = filters // bottleneck_ratio
    self.downsample = downsample
    self.conv0 = Conv(in_features, hidden, (1, 1), **kw)
    self.conv1 = Conv(hidden, hidden, (3, 3), **kw)
    self.conv2 = Conv(hidden, hidden, (3, 3), **kw)
    self.conv3 = Conv(hidden, filters, (1, 1), **kw)
    self.conv_sc = (Conv(in_features, filters - in_features, (1, 1), **kw)
                    if in_features != filters else None)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    residual = x
    x = self.conv0(F.relu(x))
    x = self.conv1(F.relu(x))
    x = F.relu(self.conv2(F.relu(x)))
    if self.downsample:
      residual = dsample(residual)
      x = dsample(x)
    x = self.conv3(x)
    if self.conv_sc is not None:
      residual = torch.cat([residual, self.conv_sc(residual)], dim=1)
    return x + residual


class DiscOptimizedBlock(_Convs):
  """First discriminator block (conv before activation, as in SNGAN)."""

  def __init__(self, in_features: int, filters: int, *, spectral: bool,
               scale_fuse: bool, dtype, device=None,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    kw = dict(spectral=spectral, dtype=dtype, device=device,
              generator=generator)
    self.scale_fuse = scale_fuse
    convs = [Conv(in_features, filters, (3, 3), **kw),
             Conv(filters, filters, (3, 3),
                  scale_op="pool" if scale_fuse else "none", **kw),
             Conv(in_features, filters, (1, 1), **kw)]
    self.convs = self._add_convs(conv_prefix(spectral), convs)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    shortcut = x
    x = F.relu(self.convs[0](x))
    x = self.convs[1](x)
    if not self.scale_fuse:
      x = dsample(x)
    shortcut = self.convs[2](dsample(shortcut))
    return x + shortcut


class _GenUpBlock(nn.Module):
  """An upsampling generator block: norm-act-up-conv3, norm-act-conv3,
  plus an upsample and 1x1 shortcut.  With ``scale_fuse`` the upsample is
  folded into the first conv and the shortcut's 1x1 conv runs before its
  upsample (the same function).  Layers are registered in flax's order:
  ``<norm>_0``, ``Conv_0``, ``<norm>_1``, ``Conv_1``, ``Conv_2``
  (``SpectralConv_*`` with ``spectral``)."""

  def __init__(self, norm_cls, in_features: int, filters: int,
               cond_features: int, *, scale_fuse: bool, dtype, device=None,
               generator: Optional[torch.Generator] = None,
               norm_group_size: int = -1, spectral: bool = False):
    super().__init__()
    self.scale_fuse = scale_fuse
    kw = dict(dtype=dtype, device=device, generator=generator)
    norm_kw = dict(kw, group_size=norm_group_size, spectral=spectral)
    conv_kw = dict(kw, spectral=spectral)
    norm, conv = norm_cls.__name__, conv_prefix(spectral)
    layers = [
        (f"{norm}_0", norm_cls(in_features, cond_features, **norm_kw)),
        (f"{conv}_0", Conv(in_features, filters, (3, 3),
                           scale_op="up" if scale_fuse else "none",
                           **conv_kw)),
        (f"{norm}_1", norm_cls(filters, cond_features, **norm_kw)),
        (f"{conv}_1", Conv(filters, filters, (3, 3), **conv_kw)),
        (f"{conv}_2", Conv(in_features, filters, (1, 1), **conv_kw)),
    ]
    for name, layer in layers:
      self.add_module(name, layer)
    self.norms = [layers[0][1], layers[2][1]]
    self.convs = [layers[1][1], layers[3][1], layers[4][1]]

  def _run(self, x: torch.Tensor, cond_in: torch.Tensor,
           cond_out: torch.Tensor) -> torch.Tensor:
    shortcut = x
    x = F.relu(self.norms[0](x, cond_in))
    x = self.convs[0](x if self.scale_fuse else upsample(x))
    x = F.relu(self.norms[1](x, cond_out))
    x = self.convs[1](x)
    if self.scale_fuse:
      shortcut = upsample(self.convs[2](shortcut))
    else:
      shortcut = self.convs[2](upsample(shortcut))
    return x + shortcut


class GenBlock(_GenUpBlock):
  """Upsampling generator block with global conditional BatchNorm."""

  def __init__(self, in_features: int, filters: int, cond_features: int,
               **kw):
    super().__init__(ConditionalBatchNorm, in_features, filters,
                     cond_features, **kw)

  def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    return self._run(x, cond, cond)


class GenSpatialBlock(_GenUpBlock):
  """Upsampling generator block with spatially-local conditional
  BatchNorm (the reference layout): ``cond_in`` is the conditioning map
  at the input's resolution, ``cond_out`` at the (2x) output's."""

  def __init__(self, in_features: int, filters: int, cond_features: int,
               **kw):
    super().__init__(LocalConditionalBatchNorm, in_features, filters,
                     cond_features, **kw)

  def forward(self, x: torch.Tensor, cond_in: torch.Tensor,
              cond_out: torch.Tensor) -> torch.Tensor:
    return self._run(x, cond_in, cond_out)


class GenSpatialBlockFused(nn.Module):
  """Upsampling generator block modulated by the region-context map at its
  own resolution (``factor`` = input resolution / context resolution)."""

  def __init__(self, in_features: int, filters: int, ctx_features: int,
               global_features: int, factor: int, *, scale_fuse: bool,
               dtype, device=None,
               generator: Optional[torch.Generator] = None,
               norm_group_size: int = -1):
    super().__init__()
    kw = dict(dtype=dtype, device=device, generator=generator)
    self.scale_fuse = scale_fuse
    self.FusedSpatialModulation_0 = FusedSpatialModulation(
        in_features, ctx_features, global_features, factor,
        group_size=norm_group_size, **kw)
    self.Conv_0 = Conv(in_features, filters, (3, 3),
                       scale_op="up" if scale_fuse else "none", **kw)
    self.FusedSpatialModulation_1 = FusedSpatialModulation(
        filters, ctx_features, global_features, 2 * factor,
        group_size=norm_group_size, **kw)
    self.Conv_1 = Conv(filters, filters, (3, 3), **kw)
    self.Conv_2 = Conv(in_features, filters, (1, 1), **kw)

  def forward(self, x: torch.Tensor, region_ctx: torch.Tensor,
              global_cond: torch.Tensor) -> torch.Tensor:
    shortcut = x
    x = F.relu(self.FusedSpatialModulation_0(x, region_ctx, global_cond))
    x = self.Conv_0(x if self.scale_fuse else upsample(x))
    x = F.relu(self.FusedSpatialModulation_1(x, region_ctx, global_cond))
    x = self.Conv_1(x)
    if self.scale_fuse:
      shortcut = upsample(self.Conv_2(shortcut))
    else:
      shortcut = self.Conv_2(upsample(shortcut))
    return x + shortcut

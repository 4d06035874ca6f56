"""Batch normalization and its conditional forms (the JAX package's
``ops/normalization.py``, global-batch statistics only).

`BatchNorm` follows flax ``nn.BatchNorm`` rather than ``nn.BatchNorm2d``:
the batch variance is the biased one, ``E[x^2] - E[x]^2`` clamped at 0,
reduced in float32; the running averages keep ``momentum`` of the old
value (0.9); eps is 1e-5.  In train mode it normalizes with the batch
statistics and, unless `frozen_batch_stats` is in force, writes the
running averages; in eval mode it uses them.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
from torch import nn

from xmcgan_image_generation_tpu_torch.ops.pooling import upsample
from xmcgan_image_generation_tpu_torch.ops.spectral_norm import Conv, Dense


class BatchNorm(nn.Module):
  """flax-convention BatchNorm over axis 1 of an NCHW tensor."""

  def __init__(self, features: int, *, momentum: float = 0.9,
               epsilon: float = 1e-5, use_scale: bool = False,
               use_bias: bool = False, dtype=torch.float32, device=None):
    super().__init__()
    self.momentum = momentum
    self.epsilon = epsilon
    self.dtype = dtype
    self.update_stats = True
    self.register_buffer("mean", torch.zeros(features, device=device))
    self.register_buffer("var", torch.ones(features, device=device))
    self.scale = (nn.Parameter(torch.ones(features, device=device))
                  if use_scale else None)
    self.bias = (nn.Parameter(torch.zeros(features, device=device))
                 if use_bias else None)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    if self.training:
      axes = (0, 2, 3)
      mean = x32.mean(dim=axes)
      var = torch.clamp_min((x32 * x32).mean(dim=axes) - mean * mean, 0.0)
      if self.update_stats:
        with torch.no_grad():
          m = self.momentum
          self.mean.copy_(m * self.mean + (1 - m) * mean)
          self.var.copy_(m * self.var + (1 - m) * var)
    else:
      mean, var = self.mean, self.var
    mul = torch.rsqrt(var + self.epsilon)
    if self.scale is not None:
      mul = mul * self.scale
    y = (x32 - mean[None, :, None, None]) * mul[None, :, None, None]
    if self.bias is not None:
      y = y + self.bias[None, :, None, None]
    return y.to(self.dtype)


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module) -> Iterator[None]:
  """Runs ``module``'s BatchNorms without writing their running averages.

  The critic step runs G in train mode (batch statistics) but keeps G's
  running averages as they were.
  """
  norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
  saved = [m.update_stats for m in norms]
  for m in norms:
    m.update_stats = False
  try:
    yield
  finally:
    for m, flag in zip(norms, saved):
      m.update_stats = flag


class ConditionalBatchNorm(nn.Module):
  """BatchNorm modulated per sample: ``x (gamma + 1) + beta``, with gamma
  and beta linear in the conditioning vector (``Dense_0``, ``Dense_1``)."""

  def __init__(self, features: int, cond_features: int, *, dtype,
               device=None, generator: Optional[torch.Generator] = None):
    super().__init__()
    kw = dict(dtype=dtype, device=device, generator=generator)
    self.Dense_0 = Dense(cond_features, features, **kw)
    self.Dense_1 = Dense(cond_features, features, **kw)
    self.BatchNorm_0 = BatchNorm(features, dtype=dtype, device=device)

  def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    gamma = self.Dense_0(emb)[:, :, None, None]
    beta = self.Dense_1(emb)[:, :, None, None]
    x = self.BatchNorm_0(x)
    return x * (gamma + 1.0) + beta


class FusedSpatialModulation(nn.Module):
  """Spatially-local conditional BatchNorm at the context's resolution.

  gamma and beta are each a 1x1 conv of the region-context map
  (``*_ctx``), nearest-upsampled by ``factor``, plus a dense of the global
  conditioning vector (``*_global``) broadcast over space.
  """

  def __init__(self, features: int, ctx_features: int,
               global_features: int, factor: int = 1, *, dtype,
               device=None, generator: Optional[torch.Generator] = None):
    super().__init__()
    kw = dict(dtype=dtype, device=device, generator=generator)
    self.factor = factor
    self.gamma_ctx = Conv(ctx_features, features, (1, 1), use_bias=False,
                          **kw)
    self.gamma_global = Dense(global_features, features, **kw)
    self.beta_ctx = Conv(ctx_features, features, (1, 1), use_bias=False,
                         **kw)
    self.beta_global = Dense(global_features, features, **kw)
    self.BatchNorm_0 = BatchNorm(features, dtype=dtype, device=device)

  def _modulation(self, conv, dense, region_ctx, global_cond):
    local = conv(region_ctx)
    if self.factor > 1:
      local = upsample(local, self.factor)
    return local + dense(global_cond)[:, :, None, None]

  def forward(self, x: torch.Tensor, region_ctx: torch.Tensor,
              global_cond: torch.Tensor) -> torch.Tensor:
    gamma = self._modulation(self.gamma_ctx, self.gamma_global, region_ctx,
                             global_cond)
    beta = self._modulation(self.beta_ctx, self.beta_global, region_ctx,
                            global_cond)
    x = self.BatchNorm_0(x)
    return x * (gamma + 1.0) + beta

"""Batch normalization and its conditional forms (the JAX package's
``ops/normalization.py``).

`BatchNorm` follows flax ``nn.BatchNorm`` rather than ``nn.BatchNorm2d``:
the batch variance is the biased one, ``E[x^2] - E[x]^2`` clamped at 0,
reduced in float32; the running averages keep ``momentum`` of the old
value (0.9); eps is 1e-5.  In train mode it normalizes with the batch
statistics and, unless `frozen_batch_stats` is in force, writes the
running averages; in eval mode it uses them.

The statistics are over the global batch, as under the JAX package's
GSPMD mesh: with an ambient process group (`parallel.context`) each
process holds its rows, and the per-process sums of ``x`` and ``x^2``
are summed over processes (`parallel.collectives.all_reduce_with_grad`,
whose backward sums their cotangents too).  Every process holds the same
number of rows.  `GroupedBatchNorm` (``batch_norm_group_size > 0``) takes
its statistics over contiguous groups of examples of the global batch, a
group possibly spanning processes, and keeps the global statistics as
running averages.  ``torch.nn.SyncBatchNorm`` is not used: its Welford
statistics are another formula.

The modulated norms (`ConditionalBatchNorm`, `LocalConditionalBatchNorm`,
`FusedSpatialModulation`) compute ``BatchNorm(x) (gamma + 1) + beta`` and,
with ``relu``, the block's ReLU after it.  On a CUDA tensor in train mode
with the global-batch `BatchNorm` the whole chain is one autograd function
over a hand-written kernel family (`ops.cuda.modulated_norm`); elsewhere
(the CPU, eval mode and so the exported G, `GroupedBatchNorm`) it runs as
these modules' separate operations.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
from torch import nn
import torch.nn.functional as F

from xmcgan_image_generation_tpu_torch.ops.cuda.modulated_norm import (
    modulated_batch_norm,
    modulation,
)
from xmcgan_image_generation_tpu_torch.ops.spectral_norm import (
    Conv,
    Dense,
    frozen_u0,
)
from xmcgan_image_generation_tpu_torch.parallel import collectives
from xmcgan_image_generation_tpu_torch.parallel import context

_AXES = (0, 2, 3)


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

  def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
    if self.update_stats:
      with torch.no_grad():
        m = self.momentum
        self.mean.copy_(m * self.mean + (1 - m) * mean)
        self.var.copy_(m * self.var + (1 - m) * var)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    if not self.training:
      mean, var = self.mean, self.var
    else:
      sums = torch.stack([x32.sum(dim=_AXES), (x32 * x32).sum(dim=_AXES)])
      sums = collectives.all_reduce_with_grad(sums, tag="batch_norm")
      count = x32.numel() // x32.shape[1] * context.ambient_data_axis_size()
      mean = sums[0] / count
      var = torch.clamp_min(sums[1] / count - mean * mean, 0.0)
      self._update(mean, var)
    mul = torch.rsqrt(var + self.epsilon)
    if self.scale is not None:
      mul = mul * self.scale
    y = (x32 - mean[None, :, None, None]) * mul[None, :, None, None]
    if self.bias is not None:
      y = y + self.bias[None, :, None, None]
    return y.to(self.dtype)


class GroupedBatchNorm(BatchNorm):
  """BatchNorm with statistics over contiguous groups of ``group_size``
  examples of the global batch (the JAX package's ``GroupedBatchNorm``):
  each example is normalized with its group's mean and ``E[x^2] -
  E[x]^2`` (not clamped, as in JAX); the running averages take the global
  statistics (the mean of the groups' moments).  With a process group,
  process ``r``'s rows are rows ``[r b, (r + 1) b)`` of the global batch,
  and one sum over processes of a ``[groups, 2, C]`` tensor of per-group
  partial sums gives every group's moments, whichever processes it
  spans."""

  def __init__(self, features: int, group_size: int, **kw):
    super().__init__(features, **kw)
    self.group_size = int(group_size)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    if self.training:
      y = self._grouped(x32)
    else:
      y = ((x32 - self.mean[None, :, None, None])
           * torch.rsqrt(self.var + self.epsilon)[None, :, None, None])
    # JAX's order: cast, then scale and bias in the compute dtype.
    y = y.to(self.dtype)
    if self.scale is not None:
      y = y * self.scale.to(self.dtype)[None, :, None, None]
    if self.bias is not None:
      y = y + self.bias.to(self.dtype)[None, :, None, None]
    return y

  def _grouped(self, x32: torch.Tensor) -> torch.Tensor:
    """``x32`` normalized with its groups' statistics (float32); writes
    the running averages."""
    mesh = context.active_mesh()
    world, rank = (1, 0) if mesh is None else (mesh.world, mesh.rank)
    local = x32.shape[0]
    batch = local * world
    if batch % self.group_size:
      raise ValueError(f"batch {batch} not divisible by "
                       f"batch_norm_group_size={self.group_size}")
    groups = batch // self.group_size
    rows = torch.stack([x32.sum(dim=(2, 3)), (x32 * x32).sum(dim=(2, 3))],
                       dim=1)                                # [b, 2, C]
    owner = (torch.arange(local, device=x32.device) + rank * local
             ) // self.group_size
    sums = torch.zeros((groups,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                       device=x32.device).index_add(0, owner, rows)
    sums = collectives.all_reduce_with_grad(sums, tag="batch_norm")
    moments = sums / (self.group_size * x32.shape[2] * x32.shape[3])
    g_mean, g_sq = moments[:, 0], moments[:, 1]                # [G, C]
    g_var = g_sq - g_mean * g_mean
    mean_rows, var_rows = g_mean[owner], g_var[owner]          # [b, C]
    y = ((x32 - mean_rows[:, :, None, None])
         * torch.rsqrt(var_rows + self.epsilon)[:, :, None, None])
    mean = g_mean.mean(dim=0)
    self._update(mean, g_sq.mean(dim=0) - mean * mean)
    return y


def make_batch_norm(features: int, group_size: int = -1, **kw
                    ) -> BatchNorm:
  """`GroupedBatchNorm` when ``group_size > 0``, else `BatchNorm` (the
  JAX package's ``_make_norm_fn``)."""
  if group_size and group_size > 0:
    return GroupedBatchNorm(features, group_size, **kw)
  return BatchNorm(features, **kw)


def norm_name(group_size: int = -1) -> str:
  """The flax scope name of a conditional norm's BatchNorm, which the
  bridge and the checkpoints follow."""
  return ("GroupedBatchNorm_0" if group_size and group_size > 0
          else "BatchNorm_0")


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


@contextlib.contextmanager
def frozen_state(module: nn.Module) -> Iterator[None]:
  """Runs ``module`` without writing any of its state: neither the
  BatchNorms' running averages nor the spectral layers' ``u0``.

  The critic step runs G in train mode (batch statistics, the spectral
  kernels normalized with the stored ``u0``) and keeps G's state as it
  was, as the JAX critic step throws G's new collections away.
  """
  with frozen_batch_stats(module), frozen_u0(module):
    yield


class _Modulated(nn.Module):
  """BatchNorm without scale or bias, modulated as ``x (gamma + 1) +
  beta``; gamma and beta come from the two layers ``<prefix>_0`` and
  ``<prefix>_1``."""

  def _add_layers(self, prefix: str, features: int, group_size: int,
                  make_layer, dtype, device) -> None:
    self.layer_names = (f"{prefix}_0", f"{prefix}_1")
    for name in self.layer_names:
      self.add_module(name, make_layer())
    self.norm_name = norm_name(group_size)
    self.add_module(self.norm_name, make_batch_norm(
        features, group_size, dtype=dtype, device=device))

  def _gamma_beta(self, cond: torch.Tensor):
    return (getattr(self, name)(cond) for name in self.layer_names)


def takes_kernels(norm: BatchNorm, x: torch.Tensor) -> bool:
  """Whether a modulated norm runs as `modulated_batch_norm`: for a CUDA
  tensor in train mode with the global-batch `BatchNorm`."""
  return x.is_cuda and norm.training and type(norm) is BatchNorm


def _modulate(norm: BatchNorm, x: torch.Tensor, gamma, beta, factor: int,
              relu: bool) -> torch.Tensor:
  """``norm(x) (gamma + 1) + beta``, ReLU'd with ``relu``; ``gamma`` and
  ``beta`` are (local, dense) pairs of `modulation` terms."""
  if takes_kernels(norm, x):
    out, mean, var = modulated_batch_norm(x, *gamma, *beta, factor, relu,
                                          norm.epsilon)
    norm._update(mean, var)
    return out
  out = norm(x) * (modulation(*gamma, factor) + 1.0) + modulation(
      *beta, factor)
  return F.relu(out) if relu else out


class ConditionalBatchNorm(_Modulated):
  """BatchNorm modulated per sample: gamma and beta are linear in the
  conditioning vector (``Dense_0``, ``Dense_1``; ``SpectralDense_*``
  with ``spectral``)."""

  def __init__(self, features: int, cond_features: int, *, dtype,
               device=None, generator: Optional[torch.Generator] = None,
               group_size: int = -1, spectral: bool = False):
    super().__init__()
    self._add_layers(
        "SpectralDense" if spectral else "Dense", features, group_size,
        lambda: Dense(cond_features, features, spectral=spectral,
                      dtype=dtype, device=device, generator=generator),
        dtype, device)

  def forward(self, x: torch.Tensor, emb: torch.Tensor,
              relu: bool = False) -> torch.Tensor:
    gamma, beta = self._gamma_beta(emb)
    return _modulate(getattr(self, self.norm_name), x, (None, gamma),
                     (None, beta), 1, relu)


class LocalConditionalBatchNorm(_Modulated):
  """BatchNorm with spatial modulation: gamma and beta are 1x1 convs (with
  bias) of a conditioning map at ``x``'s resolution (``Conv_0``,
  ``Conv_1``; ``SpectralConv_*`` with ``spectral``): each pixel gets its
  own affine modulation."""

  def __init__(self, features: int, cond_features: int, *, dtype,
               device=None, generator: Optional[torch.Generator] = None,
               group_size: int = -1, spectral: bool = False):
    super().__init__()
    self._add_layers(
        "SpectralConv" if spectral else "Conv", features, group_size,
        lambda: Conv(cond_features, features, (1, 1), spectral=spectral,
                     dtype=dtype, device=device, generator=generator),
        dtype, device)

  def forward(self, x: torch.Tensor, cond: torch.Tensor,
              relu: bool = False) -> torch.Tensor:
    gamma, beta = self._gamma_beta(cond)
    return _modulate(getattr(self, self.norm_name), x, (gamma, None),
                     (beta, None), 1, relu)


class FusedSpatialModulation(nn.Module):
  """Spatially-local conditional BatchNorm at the context's resolution.

  gamma and beta are each a 1x1 conv of the region-context map
  (``*_ctx``), nearest-upsampled by ``factor``, plus a dense of the global
  conditioning vector (``*_global``) broadcast over space.
  """

  def __init__(self, features: int, ctx_features: int,
               global_features: int, factor: int = 1, *, dtype,
               device=None, generator: Optional[torch.Generator] = None,
               group_size: int = -1):
    super().__init__()
    kw = dict(dtype=dtype, device=device, generator=generator)
    self.factor = factor
    self.gamma_ctx = Conv(ctx_features, features, (1, 1), use_bias=False,
                          **kw)
    self.gamma_global = Dense(global_features, features, **kw)
    self.beta_ctx = Conv(ctx_features, features, (1, 1), use_bias=False,
                         **kw)
    self.beta_global = Dense(global_features, features, **kw)
    self.norm_name = norm_name(group_size)
    self.add_module(self.norm_name, make_batch_norm(
        features, group_size, dtype=dtype, device=device))

  def forward(self, x: torch.Tensor, region_ctx: torch.Tensor,
              global_cond: torch.Tensor, relu: bool = False) -> torch.Tensor:
    gamma = (self.gamma_ctx(region_ctx), self.gamma_global(global_cond))
    beta = (self.beta_ctx(region_ctx), self.beta_global(global_cond))
    return _modulate(getattr(self, self.norm_name), x, gamma, beta,
                     self.factor, relu)

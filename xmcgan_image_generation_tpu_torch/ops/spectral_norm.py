"""Dense and conv layers, plain or spectrally normalized.

The JAX package's ``ops/spectral_norm.py`` (``SpectralDense``,
``SpectralConv``) together with the flax ``nn.Dense`` / ``nn.Conv`` they
stand beside: one `Dense` and one `Conv`, each with a ``spectral`` switch.

* Parameters stay float32; each layer casts its input and its (normalized)
  kernel to the compute dtype and returns that dtype, as flax does.
* Spectral normalization runs one power-iteration step per forward on the
  kernel flattened to ``[fan_in, features]`` (HWIO order for a conv), with
  the additive eps 1e-10 inside the l2 and in ``sigma + eps``.  ``u`` and
  ``v`` carry no gradient, sigma does.  The persisted ``u0`` buffer
  ``[1, features]`` advances only in train mode.
* Kernels are ``[out, in]`` (Dense) and OIHW (conv); `utils.bridge` maps
  them to the flax layouts.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from xmcgan_image_generation_tpu_torch.ops import scale_fuse

SN_EPS = 1e-10


def power_iteration_normalize(
    kernel_2d: torch.Tensor, u0: torch.Tensor,
    eps: float = SN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
  """One power-iteration step on a ``[fan_in, features]`` kernel.

  Returns ``(sigma + eps, new_u0)``; the normalized kernel is the kernel
  divided by the first.
  """

  def _l2(x):
    return x * torch.rsqrt((x * x).sum() + eps)

  kernel_2d = kernel_2d.float()
  with torch.no_grad():
    v0 = _l2(u0.float() @ kernel_2d.t())
    u1 = _l2(v0 @ kernel_2d)
  sigma = ((v0 @ kernel_2d) @ u1.t())[0, 0]
  return sigma + eps, u1


def truncated_normal_(t: torch.Tensor, std: float,
                      generator: torch.Generator) -> torch.Tensor:
  """jax ``truncated_normal`` variance scaling: N(0, std') cut at +-2 std'.

  ``std`` is the target standard deviation; the truncation's shrink
  factor is undone as in ``jax.nn.initializers.variance_scaling``.
  """
  s = std / 0.87962566103423978
  return nn.init.trunc_normal_(t, 0.0, s, -2 * s, 2 * s, generator=generator)


def glorot_normal_(t: torch.Tensor, fan_in: int, fan_out: int,
                   generator: torch.Generator) -> torch.Tensor:
  return truncated_normal_(t, math.sqrt(2.0 / (fan_in + fan_out)), generator)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
  return truncated_normal_(t, math.sqrt(1.0 / fan_in), generator)


def _init_tensor(shape, init, device) -> nn.Parameter:
  t = torch.empty(shape, dtype=torch.float32)
  if init is not None:
    init(t)
  else:
    t.zero_()
  return nn.Parameter(t.to(device))


class _Layer(nn.Module):
  """Kernel, optional bias and, when spectral, the ``u0`` buffer."""

  def __init__(self, kernel_shape, features, *, use_bias, spectral, init,
               dtype, device, generator):
    super().__init__()
    self.dtype = dtype
    self.spectral = spectral
    self.kernel = _init_tensor(kernel_shape, init, device)
    self.bias = (_init_tensor((features,), None, device) if use_bias
                 else None)
    if spectral:
      u0 = torch.randn((1, features), generator=generator) * 1e-2
      self.register_buffer("u0", u0.to(device))

  def _kernel_2d(self) -> torch.Tensor:
    raise NotImplementedError

  def normalized_kernel(self) -> torch.Tensor:
    """The kernel in the compute dtype, spectrally normalized if asked;
    advances ``u0`` in train mode."""
    if not self.spectral:
      return self.kernel.to(self.dtype)
    sigma, new_u0 = power_iteration_normalize(self._kernel_2d(), self.u0)
    if self.training:
      with torch.no_grad():
        self.u0.copy_(new_u0)
    return (self.kernel / sigma).to(self.dtype)

  def _add_bias(self, y: torch.Tensor, channel_dim: int) -> torch.Tensor:
    if self.bias is None:
      return y
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + self.bias.to(self.dtype).reshape(shape)


class Dense(_Layer):
  """``y = x W^T + b`` over the last axis; ``kernel`` is ``[out, in]``."""

  def __init__(self, in_features: int, features: int, *,
               use_bias: bool = True, spectral: bool = False,
               kernel_init: str = "glorot_normal",
               dtype=torch.float32, device=None,
               generator: Optional[torch.Generator] = None):
    init = None
    if kernel_init == "glorot_normal":
      init = lambda t: glorot_normal_(t, in_features, features, generator)  # noqa: E731
    elif kernel_init == "lecun_normal":
      init = lambda t: lecun_normal_(t, in_features, generator)  # noqa: E731
    elif kernel_init != "zeros":
      raise ValueError(f"unknown kernel_init {kernel_init!r}")
    super().__init__((features, in_features), features, use_bias=use_bias,
                     spectral=spectral, init=init, dtype=dtype,
                     device=device, generator=generator)

  def _kernel_2d(self):
    return self.kernel.t()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    y = F.linear(x.to(self.dtype), self.normalized_kernel())
    return self._add_bias(y, -1)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
  """TF "SAME" padding (low, high) of one spatial axis."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


class Conv(_Layer):
  """NCHW convolution with TF "SAME" (or "VALID") padding; ``kernel`` is
  OIHW.

  ``scale_op="up"`` folds a preceding nearest 2x upsample and ``"pool"`` a
  following 2x2 average pool into a 3x3 / stride-1 conv
  (`ops.scale_fuse`); the parameters are those of the 3x3 conv.
  """

  def __init__(self, in_features: int, features: int,
               kernel_size: Sequence[int] = (3, 3), *,
               strides: Sequence[int] = (1, 1), padding: str = "SAME",
               use_bias: bool = True,
               spectral: bool = False, scale_op: str = "none",
               kernel_init: str = "glorot_normal",
               dtype=torch.float32, device=None,
               generator: Optional[torch.Generator] = None):
    kh, kw = kernel_size
    if kernel_init == "glorot_normal":
      init = lambda t: glorot_normal_(  # noqa: E731
          t, kh * kw * in_features, kh * kw * features, generator)
    elif kernel_init == "lecun_normal":
      init = lambda t: lecun_normal_(t, kh * kw * in_features, generator)  # noqa: E731
    else:
      raise ValueError(f"unknown kernel_init {kernel_init!r}")
    if scale_op not in ("none", "up", "pool"):
      raise ValueError(f"unknown scale_op: {scale_op}")
    if padding not in ("SAME", "VALID"):
      raise ValueError(f"unknown padding {padding!r}")
    if scale_op != "none" and ((kh, kw) != (3, 3)
                               or tuple(strides) != (1, 1)):
      raise ValueError(f"scale_op={scale_op} requires a 3x3/stride-1 conv")
    super().__init__((features, in_features, kh, kw), features,
                     use_bias=use_bias, spectral=spectral, init=init,
                     dtype=dtype, device=device, generator=generator)
    self.strides = tuple(strides)
    self.padding = padding
    self.scale_op = scale_op

  def _kernel_2d(self):
    # OIHW -> HWIO flattened to [kh*kw*cin, cout], the JAX order.
    return self.kernel.permute(2, 3, 1, 0).reshape(-1, self.kernel.shape[0])

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    w = self.normalized_kernel()
    x = x.to(self.dtype)
    if self.scale_op == "up":
      y = scale_fuse.upsample_conv_dilated(x, w)
    elif self.scale_op == "pool":
      y = scale_fuse.conv_pool(x, w)
    elif self.padding == "VALID":
      y = F.conv2d(x, w, stride=self.strides)
    else:
      kh, kw = w.shape[2:]
      (pt, pb), (pl, pr) = (
          same_padding(x.shape[2], kh, self.strides[0]),
          same_padding(x.shape[3], kw, self.strides[1]))
      if pt == pb and pl == pr:
        y = F.conv2d(x, w, stride=self.strides, padding=(pt, pl))
      else:
        y = F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, stride=self.strides)
    return self._add_bias(y, 1)

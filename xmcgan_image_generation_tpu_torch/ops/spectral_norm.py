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
  ``[1, features]`` advances only in train mode, and not inside
  `frozen_u0` (the critic step runs G in train mode and keeps its state).
  The iteration reads the kernel in float32, whatever it is stored in: a
  bfloat16 kernel's sigma is that of its rounded values, as in JAX.
* Kernels are ``[out, in]`` (Dense) and OIHW (conv); `utils.bridge` maps
  them to the flax layouts.
* Under recompute (``models.xmc_net``'s remat) the normalized kernels are
  computed once, outside the recomputed region, and handed in through
  `precomputed_kernels`: the recompute then sees the forward's sigma and
  leaves ``u0`` alone, as flax's ``nn.remat`` returns the mutable
  collections of the forward alone.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence, Tuple

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
  # ``u`` and ``v`` carry no gradient (JAX's stop_gradient).  Detaching
  # the kernel, rather than a no_grad region, keeps the grad mode as it
  # is: ``torch.export`` traces a grad-mode switch as a submodule each.
  frozen = kernel_2d.detach()
  v0 = _l2(u0.float() @ frozen.t())
  u1 = _l2(v0 @ frozen)
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
  """A float32 parameter drawn by ``init`` (zeros when None) on the CPU,
  then moved; on the ``meta`` device, shapes only (nothing is drawn)."""
  if device is not None and torch.device(device).type == "meta":
    return nn.Parameter(torch.empty(shape, device="meta"))
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
    self.kernel_override = None   # see `precomputed_kernels`
    self.update_u0 = True         # see `frozen_u0`
    if spectral:
      u0 = torch.randn((1, features), generator=generator) * 1e-2
      self.register_buffer("u0", u0.to(device))

  def _kernel_2d(self, kernel: torch.Tensor) -> torch.Tensor:
    """``kernel`` (this layer's layout) as ``[fan_in, features]``."""
    raise NotImplementedError

  def normalize(self, kernel: torch.Tensor) -> torch.Tensor:
    """``kernel`` (this layer's shape, any float dtype) in the compute
    dtype, spectrally normalized if the layer is; advances ``u0`` in
    train mode outside `frozen_u0`."""
    if not self.spectral:
      return kernel.to(self.dtype)
    sigma, new_u0 = power_iteration_normalize(self._kernel_2d(kernel),
                                              self.u0)
    if self.training and self.update_u0:
      with torch.no_grad():
        self.u0.copy_(new_u0)
    return (kernel.float() / sigma).to(self.dtype)

  def normalized_kernel(self) -> torch.Tensor:
    """`normalize` of the layer's own kernel; inside
    `precomputed_kernels`, the kernel handed in."""
    if self.kernel_override is not None:
      return self.kernel_override
    return self.normalize(self.kernel)

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

  def _kernel_2d(self, kernel):
    return kernel.t()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    y = F.linear(x.to(self.dtype), self.normalized_kernel())
    return self._add_bias(y, -1)


@contextlib.contextmanager
def precomputed_kernels(layers: Sequence[_Layer],
                        kernels: Sequence[torch.Tensor]) -> Iterator[None]:
  """Within the block, ``layers[i]`` computes with ``kernels[i]`` (from
  its `normalized_kernel`, taken before) instead of normalizing again."""
  for layer, kernel in zip(layers, kernels, strict=True):
    layer.kernel_override = kernel
  try:
    yield
  finally:
    for layer in layers:
      layer.kernel_override = None


@contextlib.contextmanager
def frozen_u0(module: nn.Module) -> Iterator[None]:
  """Runs ``module``'s spectral layers without writing their ``u0``: they
  normalize with the stored ``u0`` (train mode or not)."""
  layers = [m for m in module.modules() if isinstance(m, _Layer)]
  saved = [m.update_u0 for m in layers]
  for m in layers:
    m.update_u0 = False
  try:
    yield
  finally:
    for m, flag in zip(layers, saved):
      m.update_u0 = flag


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

  def _kernel_2d(self, kernel):
    # OIHW -> HWIO flattened to [kh*kw*cin, cout], the JAX order.
    return kernel.permute(2, 3, 1, 0).reshape(-1, kernel.shape[0])

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

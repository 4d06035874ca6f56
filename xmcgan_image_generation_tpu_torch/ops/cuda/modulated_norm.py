"""G's modulated BatchNorms as one kernel family (``csrc/modulated_norm.cu``).

`modulated_batch_norm` is the train-mode chain of `ops.normalization`'s
`BatchNorm` (no scale or bias), the conditional modulation ``y (gamma +
1) + beta`` and, with ``relu``, the block's ReLU, as one autograd
function.  gamma and beta are each the sum of an optional local map
``[N, C, H / factor, W / factor]``, nearest-upsampled by ``factor``, and
an optional dense term ``[N, C]``: `ConditionalBatchNorm` gives the dense
terms, `LocalConditionalBatchNorm` the local ones at factor 1,
`FusedSpatialModulation` both.  It returns ``(out, mean, var)``; the
batch statistics are not differentiable, for the module's running
averages.  With a process group the per-channel sums are summed over
processes, forward and backward (`parallel.collectives.all_reduce`).

Four stages, each a kernel for CUDA tensors and a plain PyTorch version
for CPU tensors, in this module:

* `norm_stats`: the per-channel ``(sum x, sum x^2)``, ``[2, C]``;
* `norm_apply`: the output, from the (process-summed) sums, rounded to
  the input's type at every point the unfused modules round, so that it
  is theirs bit for bit given the same sums;
* `norm_bwd_reduce`: from the cotangent of the output, the gradients of
  the local and dense terms and the per-channel ``(sum dy, sum dy (x -
  mean))`` that the gradient of x needs, with ``dy`` the cotangent of the
  normalized value;
* `norm_bwd_dx`: the gradient of x from those sums (process-summed).

Nothing but x, the sums and the terms is kept for the backward: it
recomputes the normalized value and the ReLU's mask.  Each stage's
launches are counted on its function (``.launches``).  The kernels need
bf16 or float32, planes whose sides are powers of two and a
power-of-two factor; the plain stages take any float type and, as
`BatchNorm`, reduce the statistics in float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from xmcgan_image_generation_tpu_torch.ops.cuda import build
from xmcgan_image_generation_tpu_torch.ops.pooling import upsample
from xmcgan_image_generation_tpu_torch.parallel import collectives
from xmcgan_image_generation_tpu_torch.parallel import context

_AXES = (0, 2, 3)
# The kernels' flags (csrc/modulated_norm.cu).
_LOCAL, _DENSE, _RELU, _BF16 = 1, 2, 4, 8
# Channels the kernels' tickets cover.
_MAX_CHANNELS = 65535


def _bcast(v: torch.Tensor) -> torch.Tensor:
  return v[None, :, None, None]


def _finalize(sums: torch.Tensor, count: int, eps: float):
  """``(mean, var, mul, passes)`` as `BatchNorm.forward` computes them
  from the sums; ``passes`` is where the clamp at 0 passes the gradient."""
  mean = sums[0] / count
  raw = sums[1] / count - mean * mean
  var = torch.clamp_min(raw, 0.0)
  return mean, var, torch.rsqrt(var + eps), raw >= 0


def modulation(local, dense, factor: int) -> torch.Tensor:
  """gamma or beta over x's positions, as the modulated norms form it:
  the local map nearest-upsampled by ``factor`` plus the dense term
  broadcast over space (either may be None)."""
  if local is None:
    return dense[:, :, None, None]
  if factor > 1:
    local = upsample(local, factor)
  return local if dense is None else local + dense[:, :, None, None]


def _normalized(x, mean, mul):
  """y as the modules store it: in x's type."""
  return ((x.to(mean.dtype) - _bcast(mean)) * _bcast(mul)).to(x.dtype)


def _recompute(x, dout, sums, count, terms, factor, relu, eps):
  """What the plain backward stages share: x and y in the accumulation
  type, gamma + 1, the ReLU-masked cotangent (all in the accumulation
  type) and the channel statistics."""
  gl, gd, bl, bd = terms
  mean, _, mul, passes = _finalize(sums, count, eps)
  y = _normalized(x, mean, mul)
  g1 = modulation(gl, gd, factor) + 1.0
  acc = mean.dtype
  dm = dout.to(acc)
  if relu:
    dm = dm * (y * g1 + modulation(bl, bd, factor) > 0)
  return x.to(acc), y.to(acc), g1.to(acc), dm, mean, mul, passes


def _tile_sum(t: torch.Tensor, factor: int) -> torch.Tensor:
  n, c, h, w = t.shape
  return t.reshape(n, c, h // factor, factor, w // factor, factor).sum(
      (3, 5))


def stats_plain(x: torch.Tensor) -> torch.Tensor:
  """``[2, C]``: ``(sum x, sum x^2)`` over (N, H, W), as `BatchNorm`."""
  x = x.float()
  return torch.stack([x.sum(dim=_AXES), (x * x).sum(dim=_AXES)])


def apply_plain(x, sums, count, gl, gd, bl, bd, factor=1, relu=False,
                eps=1e-5):
  """``(out, mean, var)``: the modules' forward from the sums."""
  mean, var, mul, _ = _finalize(sums, count, eps)
  y = _normalized(x, mean, mul)
  out = y * (modulation(gl, gd, factor) + 1.0) + modulation(bl, bd, factor)
  return (torch.relu(out) if relu else out), mean, var


def bwd_reduce_plain(x, dout, sums, count, gl, gd, bl, bd, factor=1,
                     relu=False, eps=1e-5):
  """``(gsums, d gamma_local, d gamma_dense, d beta_local, d beta_dense)``
  for the cotangent ``dout`` of the output; ``gsums`` is ``[2, C]``:
  ``(sum dy, sum dy (x - mean))`` over this process's rows."""
  xa, y, g1, dm, mean, _, _ = _recompute(x, dout, sums, count,
                                         (gl, gd, bl, bd), factor, relu, eps)
  dy = dm * g1
  gsums = torch.stack([dy.sum(dim=_AXES),
                       (dy * (xa - _bcast(mean))).sum(dim=_AXES)])
  prod = dm * y

  def grads(like_local, like_dense, t):
    local = (None if like_local is None
             else _tile_sum(t, factor).to(like_local.dtype))
    dense = None if like_dense is None else t.sum((2, 3)).to(like_dense.dtype)
    return local, dense

  dgl, dgd = grads(gl, gd, prod)
  dbl, dbd = grads(bl, bd, dm)
  return gsums, dgl, dgd, dbl, dbd


def bwd_dx_plain(x, dout, sums, gsums, count, gl, gd, bl, bd, factor=1,
                 relu=False, eps=1e-5):
  """The gradient of x from `bwd_reduce_plain`'s sums (over processes):
  through y, the mean, the clamp and the rsqrt, as autograd takes it
  through `BatchNorm.forward`."""
  xa, _, g1, dm, mean, mul, passes = _recompute(
      x, dout, sums, count, (gl, gd, bl, bd), factor, relu, eps)
  d_var = torch.where(passes, -0.5 * gsums[1] * mul ** 3, 0.0)
  d_mean = -mul * gsums[0] - 2.0 * mean * d_var
  dx = (dm * g1 * _bcast(mul) + _bcast(d_mean / count)
        + 2.0 * xa * _bcast(d_var / count))
  return dx.to(x.dtype)


# ---------------------------------------------------------------------------
# The kernels.
# ---------------------------------------------------------------------------


def _flags(x, local, dense, relu=False) -> int:
  return ((_LOCAL if local is not None else 0)
          | (_DENSE if dense is not None else 0) | (_RELU if relu else 0)
          | (_BF16 if x.dtype == torch.bfloat16 else 0))


def _ptr(t) -> int:
  return 0 if t is None else t.data_ptr()


def _stream(x) -> int:
  return torch.cuda.current_stream(x.device).cuda_stream


def _inv_count(count: int) -> float:
  """count's float32 reciprocal, as PyTorch divides by a scalar on the
  card (by multiplying with it)."""
  return float(np.float32(1.0) / np.float32(count))


@functools.lru_cache(maxsize=None)
def _tickets(device: torch.device, stream: int) -> torch.Tensor:
  """The kernels' per-channel completion counters for launches on
  ``stream`` of ``device``: zero between launches (the last block of each
  channel resets its own).  Launches on one stream run in turn; two
  streams could run two launches at once, so each has its own."""
  del stream   # a key of the cache; the caller runs on it
  return torch.zeros((_MAX_CHANNELS,), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _partial_floats(shape, log_f: int, flags: int) -> int:
  n, c, h, w = shape
  floats = build.library().xmc_modnorm_partial_floats(n, c, h, w, log_f,
                                                      flags)
  if floats < 0:
    raise ValueError(f"the modulated-norm kernels refuse x {shape} at factor "
                     f"{1 << log_f}")
  return floats


def _scratch(x, log_f, flags):
  """The tickets and the partial sums for a launch at x's shape.  The
  caller holds both until the launch is queued: a buffer freed before
  then could be handed to another tensor that the launch's kernel then
  writes over (the tickets themselves, on their first allocation)."""
  tickets = _tickets(x.device, _stream(x))
  partial = torch.empty((_partial_floats(tuple(x.shape), log_f, flags),),
                        dtype=torch.float32, device=x.device)
  return tickets, partial


def _kernel_ready(x: torch.Tensor) -> None:
  if x.device.type != "cuda":
    raise ValueError(f"the modulated-norm kernels have no {x.device} form")


def _aligned(t: torch.Tensor) -> torch.Tensor:
  """``t`` contiguous and 16-byte aligned, for the kernels' loads."""
  t = t.contiguous()
  return t.clone() if t.data_ptr() % 16 else t


def norm_stats(x: torch.Tensor) -> torch.Tensor:
  """``[2, C]`` float32 sums: kernel ``modnorm_stats`` on CUDA, plain on
  the CPU."""
  if x.device.type == "cpu":
    return stats_plain(x)
  _kernel_ready(x)
  n, c, h, w = x.shape
  flags = _flags(x, None, None)
  sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
  tickets, partial = _scratch(x, 0, flags)
  status = build.library().xmc_modnorm_stats(
      x.data_ptr(), partial.data_ptr(), tickets.data_ptr(), sums.data_ptr(),
      n, c, h, w, flags, _stream(x))
  build.check(status, "modnorm_stats kernel")
  norm_stats.launches += 1
  return sums


norm_stats.launches = 0


def norm_apply(x, sums, count, gl, gd, bl, bd, factor=1, relu=False,
               eps=1e-5):
  """``(out, mean, var)``: kernel ``modnorm_apply`` on CUDA, plain on the
  CPU."""
  if x.device.type == "cpu":
    return apply_plain(x, sums, count, gl, gd, bl, bd, factor, relu, eps)
  _kernel_ready(x)
  n, c, h, w = x.shape
  out = torch.empty_like(x)
  mean = torch.empty((c,), dtype=torch.float32, device=x.device)
  var = torch.empty_like(mean)
  status = build.library().xmc_modnorm_apply(
      x.data_ptr(), sums.data_ptr(), _ptr(gl), _ptr(gd), _ptr(bl), _ptr(bd),
      out.data_ptr(), mean.data_ptr(), var.data_ptr(), n, c, h, w,
      factor.bit_length() - 1, _flags(x, gl, gd, relu), _inv_count(count),
      eps, _stream(x))
  build.check(status, "modnorm_apply kernel")
  norm_apply.launches += 1
  return out, mean, var


norm_apply.launches = 0


def norm_bwd_reduce(x, dout, sums, count, gl, gd, bl, bd, factor=1,
                    relu=False, eps=1e-5):
  """``(gsums, dgl, dgd, dbl, dbd)``: kernel ``modnorm_bwd_reduce`` on
  CUDA, plain on the CPU."""
  if x.device.type == "cpu":
    return bwd_reduce_plain(x, dout, sums, count, gl, gd, bl, bd, factor,
                            relu, eps)
  _kernel_ready(x)
  n, c, h, w = x.shape
  log_f = factor.bit_length() - 1
  flags = _flags(x, gl, gd, relu)
  grads = [None if t is None else torch.empty_like(t)
           for t in (gl, gd, bl, bd)]
  gsums = torch.empty((2, c), dtype=torch.float32, device=x.device)
  tickets, partial = _scratch(x, log_f, flags)
  status = build.library().xmc_modnorm_bwd_reduce(
      x.data_ptr(), dout.data_ptr(), sums.data_ptr(), _ptr(gl), _ptr(gd),
      _ptr(bl), _ptr(bd), *(_ptr(g) for g in grads), partial.data_ptr(),
      tickets.data_ptr(), gsums.data_ptr(), n, c, h, w, log_f, flags,
      _inv_count(count), eps, _stream(x))
  build.check(status, "modnorm_bwd_reduce kernel")
  norm_bwd_reduce.launches += 1
  return (gsums, *grads)


norm_bwd_reduce.launches = 0


def norm_bwd_dx(x, dout, sums, gsums, count, gl, gd, bl, bd, factor=1,
                relu=False, eps=1e-5):
  """The gradient of x: kernel ``modnorm_bwd_dx`` on CUDA, plain on the
  CPU."""
  if x.device.type == "cpu":
    return bwd_dx_plain(x, dout, sums, gsums, count, gl, gd, bl, bd, factor,
                        relu, eps)
  _kernel_ready(x)
  n, c, h, w = x.shape
  dx = torch.empty_like(x)
  status = build.library().xmc_modnorm_bwd_dx(
      x.data_ptr(), dout.data_ptr(), sums.data_ptr(), gsums.data_ptr(),
      _ptr(gl), _ptr(gd), _ptr(bl), _ptr(bd), dx.data_ptr(), n, c, h, w,
      factor.bit_length() - 1, _flags(x, gl, gd, relu), _inv_count(count),
      eps, _stream(x))
  build.check(status, "modnorm_bwd_dx kernel")
  norm_bwd_dx.launches += 1
  return dx


norm_bwd_dx.launches = 0


# ---------------------------------------------------------------------------
# The autograd function.
# ---------------------------------------------------------------------------


def _power_of_two(v: int) -> bool:
  return v >= 1 and v & (v - 1) == 0


def _check(x, gl, gd, bl, bd, factor: int) -> None:
  if x.dim() != 4:
    raise ValueError(f"modulated_batch_norm takes x [N, C, H, W], got "
                     f"{tuple(x.shape)}")
  if (gl is None) != (bl is None) or (gd is None) != (bd is None):
    raise ValueError("gamma and beta need the same terms")
  if gl is None and gd is None:
    raise ValueError("gamma and beta need a local or a dense term")
  n, c, h, w = x.shape
  if not _power_of_two(factor) or h % factor or w % factor:
    raise ValueError(f"factor {factor} is no power of two dividing {h}x{w}")
  local, dense = (n, c, h // factor, w // factor), (n, c)
  for t, want in ((gl, local), (bl, local), (gd, dense), (bd, dense)):
    if t is None:
      continue
    if tuple(t.shape) != want:
      raise ValueError(f"a modulation term is {tuple(t.shape)}, not {want}")
    if t.dtype != x.dtype or t.device != x.device:
      raise ValueError("the modulation terms differ from x in dtype or "
                       "device")
  if x.device.type != "cuda":
    return
  vec = 16 // x.element_size()
  if x.dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f"the modulated-norm kernels take float32 or bfloat16, "
                    f"not {x.dtype}")
  if not (_power_of_two(h) and _power_of_two(w)) or (h * w) % vec:
    raise ValueError(f"the modulated-norm kernels need power-of-two sides "
                     f"of at least {vec} elements a plane, not {h}x{w}")
  if gl is not None and w % vec:
    raise ValueError(f"a local term needs rows of whole {vec}-element "
                     f"vectors, not {w}")
  if x.numel() >= 2 ** 31 or c > _MAX_CHANNELS:
    raise ValueError(f"x {tuple(x.shape)} is too large for the kernels")


class _ModulatedBatchNorm(torch.autograd.Function):
  """The four stages, with the sums over processes between them."""

  @staticmethod
  def forward(ctx, x, gl, gd, bl, bd, factor, relu, eps):
    mesh = context.active_mesh()
    count = x.numel() // x.shape[1] * context.ambient_data_axis_size()
    sums = collectives.all_reduce(norm_stats(x), mesh=mesh, tag="batch_norm")
    out, mean, var = norm_apply(x, sums, count, gl, gd, bl, bd, factor,
                                relu, eps)
    ctx.save_for_backward(x, sums, gl, gd, bl, bd)
    ctx.setup = (mesh, count, factor, relu, eps)
    ctx.mark_non_differentiable(mean, var)
    return out, mean, var

  @staticmethod
  def backward(ctx, dout, _mean, _var):
    x, sums, gl, gd, bl, bd = ctx.saved_tensors
    mesh, count, factor, relu, eps = ctx.setup
    dout = _aligned(dout)
    terms = (gl, gd, bl, bd)
    gsums, dgl, dgd, dbl, dbd = norm_bwd_reduce(x, dout, sums, count, *terms,
                                                factor, relu, eps)
    dx = None
    if ctx.needs_input_grad[0]:
      gsums = collectives.all_reduce(gsums, mesh=mesh, tag="batch_norm")
      dx = norm_bwd_dx(x, dout, sums, gsums, count, *terms, factor, relu,
                       eps)
    return dx, dgl, dgd, dbl, dbd, None, None, None


def modulated_batch_norm(x: torch.Tensor, gamma_local=None, gamma_dense=None,
                         beta_local=None, beta_dense=None, factor: int = 1,
                         relu: bool = False, eps: float = 1e-5):
  """``(out, mean, var)`` of the train-mode modulated BatchNorm (module
  docstring); ``mean`` and ``var`` (float32 ``[C]``, the biased variance)
  are not differentiable."""
  factor = int(factor)
  _check(x, gamma_local, gamma_dense, beta_local, beta_dense, factor)
  terms = [None if t is None else t.contiguous()
           for t in (gamma_local, gamma_dense, beta_local, beta_dense)]
  return _ModulatedBatchNorm.apply(_aligned(x), *terms, factor,
                                   bool(relu), float(eps))

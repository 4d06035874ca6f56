"""Fused NT-Xent: the port of the JAX package's ``ops/pallas/ntxent.py``.

`ntxent_stats` computes, from two aligned ``[B, D]`` feature sets,
``f32[3] = (loss_ab + loss_ba, mean accuracy, mean entropy)`` of the
symmetric InfoNCE loss at a temperature.  For CUDA tensors it launches
kernel ``ntxent_fwd`` of ``csrc/ntxent.cu`` (the port of
``_ntxent_kernel``), which also fills a small record (the logits, the
inverse row norms and the log-sum-exp of every row and column); for CPU
tensors it runs `ntxent_plain`, the same function in plain PyTorch.
`ntxent_bwd` gives the loss's gradient with respect to both inputs:
kernel ``ntxent_bwd``, one launch from the record, for CUDA tensors (the
port's counterpart of the TPU's XLA-fused jnp ``_bwd``), and
`ntxent_bwd_plain`, that analytic formula in PyTorch, for CPU tensors.
`nt_xent_fused` wraps both in an autograd function.
"""

from __future__ import annotations

import functools

import torch

from xmcgan_image_generation_tpu_torch.ops.contrastive import l2_normalize
from xmcgan_image_generation_tpu_torch.ops.cuda import build


def _direction_stats(logits: torch.Tensor):
  """(mean CE on the diagonal, accuracy, entropy) with softmax over rows."""
  batch = logits.shape[0]
  m = logits.max(dim=1, keepdim=True).values
  e = torch.exp(logits - m)
  z = e.sum(dim=1, keepdim=True)
  logp = logits - m - torch.log(z)
  loss = -torch.diagonal(logp).sum() / batch
  # A tie with the diagonal counts as correct, as in the TPU kernel.
  acc = (torch.diagonal(logits) >= m[:, 0]).float().sum() / batch
  prob = e / z
  entropy = -(prob * torch.log(prob + 1e-8)).sum() / batch
  return loss, acc, entropy


def ntxent_plain(feat_a: torch.Tensor, feat_b: torch.Tensor,
                 temperature: float = 0.1) -> torch.Tensor:
  """The plain PyTorch version of the kernel: ``f32[3]``."""
  a = l2_normalize(feat_a.float(), dim=-1)
  b = l2_normalize(feat_b.float(), dim=-1)
  logits = (a @ b.t()) / temperature
  loss_ab, acc_ab, ent_ab = _direction_stats(logits)
  loss_ba, acc_ba, ent_ba = _direction_stats(logits.t())
  return torch.stack([loss_ab + loss_ba, 0.5 * (acc_ab + acc_ba),
                      0.5 * (ent_ab + ent_ba)])


def _check(feat_a: torch.Tensor, feat_b: torch.Tensor) -> None:
  if feat_a.dim() != 2 or feat_a.shape != feat_b.shape:
    raise ValueError(f"nt_xent needs two [B, D] tensors of one shape, got "
                     f"{tuple(feat_a.shape)} and {tuple(feat_b.shape)}")
  if feat_a.device != feat_b.device or feat_a.dtype != feat_b.dtype:
    raise ValueError("nt_xent inputs differ in device or dtype")
  if feat_a.dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f"nt_xent takes float32 or bfloat16, not {feat_a.dtype}")
  if not (feat_a.is_contiguous() and feat_b.is_contiguous()):
    raise ValueError("nt_xent inputs must be contiguous")


def record_floats(batch: int) -> int:
  """Floats of the record the forward kernel fills for ``batch`` rows:
  the logits [B, B], the inverse norms of a and of b, and the log-sum-exp
  of every row and every column of the logits, [B] each, then the rows'
  partial statistics [3, B]."""
  return batch * batch + 7 * batch


@functools.lru_cache(maxsize=None)
def _entry_points():
  """dtype -> (forward, backward) entry points, looked up once."""
  lib = build.library()
  return {torch.float32: (lib.xmc_ntxent_fwd_f32, lib.xmc_ntxent_bwd_f32),
          torch.bfloat16: (lib.xmc_ntxent_fwd_bf16, lib.xmc_ntxent_bwd_bf16)}


@functools.lru_cache(maxsize=None)
def _ticket(device: torch.device) -> torch.Tensor:
  """The forward kernel's completion counter on ``device``: zero between
  launches (the last block of each launch resets it)."""
  return torch.zeros((1,), dtype=torch.int32, device=device)


def _cuda(feat: torch.Tensor) -> None:
  if feat.device.type != "cuda":
    raise ValueError(f"nt_xent has no kernel for {feat.device}")


def ntxent_stats(feat_a: torch.Tensor, feat_b: torch.Tensor,
                 temperature: float = 0.1,
                 record: torch.Tensor = None) -> torch.Tensor:
  """``f32[3]`` NT-Xent statistics: the kernel on CUDA, plain on the CPU.

  ``record``, a float32 tensor of `record_floats` elements beside the
  inputs, receives what `ntxent_bwd` reads (on the card; scratch is used
  when it is None).
  """
  _check(feat_a, feat_b)
  if feat_a.device.type == "cpu":
    return ntxent_plain(feat_a, feat_b, temperature)
  _cuda(feat_a)
  batch, dim = feat_a.shape
  if record is None:
    record = torch.empty((record_floats(batch),), dtype=torch.float32,
                         device=feat_a.device)
  elif (record.numel() != record_floats(batch)
        or record.dtype != torch.float32 or record.device != feat_a.device
        or not record.is_contiguous()):
    raise ValueError(f"record must be {record_floats(batch)} contiguous "
                     f"float32 values beside the inputs")
  out = torch.empty((3,), dtype=torch.float32, device=feat_a.device)
  fwd, _ = _entry_points()[feat_a.dtype]
  status = fwd(feat_a.data_ptr(), feat_b.data_ptr(), record.data_ptr(),
               out.data_ptr(), _ticket(feat_a.device).data_ptr(), batch, dim,
               float(temperature),
               torch.cuda.current_stream(feat_a.device).cuda_stream)
  build.check(status, "ntxent forward kernel")
  ntxent_stats.launches += 1
  return out


ntxent_stats.launches = 0


def ntxent_bwd_plain(feat_a: torch.Tensor, feat_b: torch.Tensor,
                     grad_loss: torch.Tensor, temperature: float = 0.1):
  """The plain version of kernel ``ntxent_bwd``: the analytic gradient of
  the JAX ``_bwd`` for a cotangent ``grad_loss`` of the loss, in the
  inputs' dtype."""
  a = feat_a.float()
  b = feat_b.float()
  an = l2_normalize(a, dim=-1)
  bn = l2_normalize(b, dim=-1)
  batch = a.shape[0]
  logits = (an @ bn.t()) / temperature
  p_row = torch.softmax(logits, dim=-1)
  p_col = torch.softmax(logits.t(), dim=-1)
  eye = torch.eye(batch, dtype=torch.float32, device=a.device)
  ds = ((p_row - eye) + (p_col - eye).t()) / (batch * temperature)
  d_an = ds @ bn
  d_bn = ds.t() @ an
  inv_a = torch.rsqrt(torch.clamp_min((a * a).sum(-1, keepdim=True), 1e-12))
  inv_b = torch.rsqrt(torch.clamp_min((b * b).sum(-1, keepdim=True), 1e-12))
  d_a = (d_an - an * (d_an * an).sum(-1, keepdim=True)) * inv_a
  d_b = (d_bn - bn * (d_bn * bn).sum(-1, keepdim=True)) * inv_b
  return ((d_a * grad_loss).to(feat_a.dtype),
          (d_b * grad_loss).to(feat_b.dtype))


def ntxent_bwd(feat_a: torch.Tensor, feat_b: torch.Tensor,
               record: torch.Tensor, grad_out: torch.Tensor,
               temperature: float = 0.1):
  """``(d_a, d_b)`` for the cotangent ``grad_out`` of the ``f32[3]``
  statistics (only the loss's, element 0, counts): one kernel launch from
  the ``record`` `ntxent_stats` filled for the same inputs on CUDA, the
  plain version (which recomputes and ignores ``record``) on the CPU."""
  _check(feat_a, feat_b)
  grad_out = grad_out.float()
  if feat_a.device.type == "cpu":
    return ntxent_bwd_plain(feat_a, feat_b, grad_out[0], temperature)
  _cuda(feat_a)
  if grad_out.device != feat_a.device:
    raise ValueError("the cotangent lies on another device than the inputs")
  batch, dim = feat_a.shape
  d_a = torch.empty_like(feat_a)
  d_b = torch.empty_like(feat_b)
  _, bwd = _entry_points()[feat_a.dtype]
  status = bwd(feat_a.data_ptr(), feat_b.data_ptr(), record.data_ptr(),
               grad_out.data_ptr(), d_a.data_ptr(), d_b.data_ptr(), batch,
               dim, float(temperature),
               torch.cuda.current_stream(feat_a.device).cuda_stream)
  build.check(status, "ntxent backward kernel")
  ntxent_bwd.launches += 1
  return d_a, d_b


ntxent_bwd.launches = 0


class _NtXent(torch.autograd.Function):
  """Kernel forward and backward on the card; the analytic backward of
  the JAX ``_bwd`` in plain PyTorch on the CPU."""

  @staticmethod
  def forward(ctx, feat_a, feat_b, temperature):
    record = (torch.empty((record_floats(feat_a.shape[0]),),
                          dtype=torch.float32, device=feat_a.device)
              if feat_a.device.type == "cuda" else None)
    ctx.save_for_backward(feat_a, feat_b, record)
    ctx.temperature = temperature
    return ntxent_stats(feat_a, feat_b, temperature, record)

  @staticmethod
  def backward(ctx, grad_out):
    # Cotangents of the accuracy and entropy are ignored (statistics).
    feat_a, feat_b, record = ctx.saved_tensors
    d_a, d_b = ntxent_bwd(feat_a, feat_b, record, grad_out, ctx.temperature)
    return d_a, d_b, None


def nt_xent_fused(feat_a: torch.Tensor, feat_b: torch.Tensor,
                  temperature: float = 0.1):
  """Fused ``(loss, accuracy, entropy)`` NT-Xent, differentiable in loss."""
  if feat_a.dtype != feat_b.dtype:
    feat_a, feat_b = feat_a.float(), feat_b.float()
  out = _NtXent.apply(feat_a.contiguous(), feat_b.contiguous(),
                      float(temperature))
  return out[0], out[1], out[2]

"""Fused NT-Xent: the port of the JAX package's ``ops/pallas/ntxent.py``.

`ntxent_stats` computes, from two aligned ``[B, D]`` feature sets,
``f32[3] = (loss_ab + loss_ba, mean accuracy, mean entropy)`` of the
symmetric InfoNCE loss at a temperature.  For CUDA tensors it launches
``csrc/ntxent.cu`` (the port of ``_ntxent_kernel``); for CPU tensors it
runs `ntxent_plain`, the same function in plain PyTorch.  `nt_xent_fused`
wraps it in an autograd function whose backward is the analytic formula
of the JAX ``_bwd``, in PyTorch: the TPU had no backward kernel either.
"""

from __future__ import annotations

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


def ntxent_stats(feat_a: torch.Tensor, feat_b: torch.Tensor,
                 temperature: float = 0.1) -> torch.Tensor:
  """``f32[3]`` NT-Xent statistics: the kernel on CUDA, plain on the CPU."""
  _check(feat_a, feat_b)
  if feat_a.device.type == "cpu":
    return ntxent_plain(feat_a, feat_b, temperature)
  if feat_a.device.type != "cuda":
    raise ValueError(f"nt_xent has no kernel for {feat_a.device}")
  batch, dim = feat_a.shape
  logits = torch.empty((batch, batch), dtype=torch.float32,
                       device=feat_a.device)
  out = torch.empty((3,), dtype=torch.float32, device=feat_a.device)
  lib = build.library()
  fn = (lib.xmc_ntxent_f32 if feat_a.dtype == torch.float32
        else lib.xmc_ntxent_bf16)
  status = fn(feat_a.data_ptr(), feat_b.data_ptr(), logits.data_ptr(),
              out.data_ptr(), batch, dim, float(temperature),
              torch.cuda.current_stream(feat_a.device).cuda_stream)
  build.check(status, "ntxent kernel")
  ntxent_stats.launches += 1
  return out


ntxent_stats.launches = 0


class _NtXent(torch.autograd.Function):
  """Kernel forward; the analytic backward of the JAX ``_bwd``."""

  @staticmethod
  def forward(ctx, feat_a, feat_b, temperature):
    ctx.save_for_backward(feat_a, feat_b)
    ctx.temperature = temperature
    return ntxent_stats(feat_a, feat_b, temperature)

  @staticmethod
  def backward(ctx, grad_out):
    # Cotangents of the accuracy and entropy are ignored (statistics).
    feat_a, feat_b = ctx.saved_tensors
    temperature = ctx.temperature
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
    g_loss = grad_out[0]
    return ((d_a * g_loss).to(feat_a.dtype), (d_b * g_loss).to(feat_b.dtype),
            None)


def nt_xent_fused(feat_a: torch.Tensor, feat_b: torch.Tensor,
                  temperature: float = 0.1):
  """Fused ``(loss, accuracy, entropy)`` NT-Xent, differentiable in loss."""
  if feat_a.dtype != feat_b.dtype:
    feat_a, feat_b = feat_a.float(), feat_b.float()
  out = _NtXent.apply(feat_a.contiguous(), feat_b.contiguous(),
                      float(temperature))
  return out[0], out[1], out[2]

"""Building blocks of the reference: named tensors, layers, losses.

A network is a function of a `Scope`, which hands out its tensors by the
port's ``state_dict`` names (``GenBlock_0.Conv_0.kernel``).  The same
function run on a `Tree` without tensors (on ``meta`` inputs) records
each name with its shape and how the benchmark draws it (`Tree.spec`).
What a forward writes (BatchNorm running averages, spectral ``u0``) goes
to `Tree.updates`, never in place, so that a recompute under
``torch.utils.checkpoint`` writes nothing and reads what the forward read;
the caller applies the updates when the update is over.

``Tree.rounding`` is applied to both operands of every convolution and
product of the networks; the identity for the reference, a lower
precision for the control.  Everything else is float32.

Conventions, which are those of the published model and of the port:
BatchNorm takes the biased variance ``E[x^2] - E[x]^2`` (clamped at 0)
with eps 1e-5 and keeps 0.9 of the old running value; convolutions pad
as TF's "SAME"; spectral normalization takes one power-iteration step a
forward on the kernel as ``[fan_in, features]`` (HWIO order for a conv),
eps 1e-10, with ``u`` and ``v`` held constant and sigma differentiated;
masked word positions take ``-1e9``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

SN_EPS = 1e-10
BN_EPS = 1e-5
BN_MOMENTUM = 0.9
NEG_INF = -1e9

Tensor = torch.Tensor
Init = Tuple  # ("glorot", fan_in, fan_out), ("lecun", fan_in), ("bias",), ...


class Tree:
  """The tensors of one network by name (``tensors=None``: record the
  names, shapes and draws instead, in `spec`)."""

  def __init__(self, tensors: Optional[Dict[str, Tensor]] = None, *,
               rounding: Optional[Callable[[Tensor], Tensor]] = None,
               remat: bool = False):
    self.tensors = tensors
    self.spec: Dict[str, Tuple[Tuple[int, ...], Init]] = {}
    self.updates: Dict[str, Tensor] = {}
    self.recording = True
    self.rounding = rounding
    self.remat = remat


class Scope:
  """A prefix of names in a `Tree`."""

  def __init__(self, tree: Tree, prefix: str = ""):
    self.tree = tree
    self.prefix = prefix

  def __call__(self, name: str) -> "Scope":
    return Scope(self.tree, f"{self.prefix}{name}.")

  def get(self, name: str, shape, init: Init) -> Tensor:
    key = self.prefix + name
    shape = tuple(int(n) for n in shape)
    if self.tree.tensors is None:
      self.tree.spec[key] = (shape, init)
      return torch.zeros(shape, device="meta")
    t = self.tree.tensors[key]
    if tuple(t.shape) != shape:
      raise ValueError(f"{key}: shape {tuple(t.shape)}, expected {shape}")
    return t

  def put(self, name: str, value: Tensor) -> None:
    if self.tree.recording:
      self.tree.updates[self.prefix + name] = value.detach()

  def r(self, x: Tensor) -> Tensor:
    """An operand of a product, in the tree's precision."""
    return x if self.tree.rounding is None else self.tree.rounding(x)

  def block(self, fn, *args: Tensor):
    """``fn(*args)``, recomputed in the backward when the tree asks for
    it (a memory choice of the reference: the values are the same)."""
    if self.tree.remat and torch.is_grad_enabled():
      return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                         preserve_rng_state=False)
    return fn(*args)


def l2_normalize(x: Tensor, eps: float = 1e-12) -> Tensor:
  """``x / max(|x|, sqrt(eps))`` over the last axis."""
  return x * torch.rsqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), eps))


def _sn_l2(x: Tensor) -> Tensor:
  return x * torch.rsqrt((x * x).sum() + SN_EPS)


def spectral(s: Scope, kernel: Tensor, kernel_2d: Tensor) -> Tensor:
  """``kernel / (sigma + eps)`` after one power-iteration step from the
  scope's ``u0``; records the new ``u0``."""
  u0 = s.get("u0", (1, kernel_2d.shape[1]), ("u0",))
  frozen = kernel_2d.detach()
  v = _sn_l2(u0 @ frozen.t())
  u = _sn_l2(v @ frozen)
  sigma = ((v @ kernel_2d) @ u.t())[0, 0]
  s.put("u0", u)
  return kernel / (sigma + SN_EPS)


def dense(s: Scope, x: Tensor, in_f: int, out_f: int, *, bias: bool = True,
          spectral_norm: bool = False, init: str = "glorot") -> Tensor:
  """``x W^T + b``; the kernel is ``[out, in]``."""
  draw = (("glorot", in_f, out_f) if init == "glorot"
          else ("lecun", in_f))
  w = s.get("kernel", (out_f, in_f), draw)
  if spectral_norm:
    w = spectral(s, w, w.t())
  y = s.r(x) @ s.r(w).t()
  if bias:
    y = y + s.get("bias", (out_f,), ("bias",))
  return y


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
  """TF "SAME" padding (low, high) of one axis."""
  out = -(-size // stride)
  total = max((out - 1) * stride + k - size, 0)
  return total // 2, total - total // 2


def _combos(w: Tensor, dim: int) -> Tensor:
  """3 taps ``(a, b, c)`` -> 4 taps ``(a, a + b, b + c, c)``."""
  a, b, c = (w.narrow(dim, i, 1) for i in range(3))
  return torch.cat([a, a + b, b + c, c], dim=dim)


def conv(s: Scope, x: Tensor, in_f: int, out_f: int, k: int, *,
         stride: int = 1, bias: bool = True, spectral_norm: bool = False,
         scale_op: Optional[str] = None, init: str = "glorot") -> Tensor:
  """NCHW convolution with "SAME" padding; the kernel is OIHW.

  ``scale_op="up"`` is ``conv3x3(upsample2x(x))`` and ``"pool"``
  ``avgpool2x2(conv3x3(x))``, each as one convolution with a 4x4 kernel
  made from the 3x3 one (the configuration's ``scale_fused_convs``: the
  same function, fewer operations)."""
  draw = (("glorot", k * k * in_f, k * k * out_f) if init == "glorot"
          else ("lecun", k * k * in_f))
  w = s.get("kernel", (out_f, in_f, k, k), draw)
  if spectral_norm:
    w = spectral(s, w, w.permute(2, 3, 1, 0).reshape(-1, out_f))
  x, w = s.r(x), s.r(w)
  if scale_op == "up":
    w4 = _combos(_combos(w, 2), 3)
    y = F.conv_transpose2d(x, w4.flip(2, 3).transpose(0, 1), stride=2,
                           padding=1)
  elif scale_op == "pool":
    y = F.conv2d(x, _combos(_combos(w, 2), 3) * 0.25, stride=2, padding=1)
  else:
    (pt, pb), (pl, pr) = (same_pads(x.shape[2], k, stride),
                          same_pads(x.shape[3], k, stride))
    if pt == pb and pl == pr:
      y = F.conv2d(x, w, stride=stride, padding=(pt, pl))
    else:
      y = F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, stride=stride)
  if bias:
    y = y + s.get("bias", (out_f,), ("bias",))[None, :, None, None]
  return y


def upsample(x: Tensor, factor: int = 2) -> Tensor:
  """Nearest-neighbour upsampling of an NCHW tensor."""
  return x if factor == 1 else F.interpolate(x, scale_factor=factor,
                                             mode="nearest")


def dsample(x: Tensor) -> Tensor:
  """2x2 average pooling, stride 2."""
  return F.avg_pool2d(x, 2)


def batch_norm(s: Scope, x: Tensor, training: bool, *,
               affine: bool = False) -> Tensor:
  """BatchNorm over N, H and W of an NCHW tensor; in training it records
  the new running averages."""
  c = x.shape[1]
  mean_run = s.get("mean", (c,), ("zeros",))
  var_run = s.get("var", (c,), ("ones",))
  if training:
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    s.put("mean", BN_MOMENTUM * mean_run + (1 - BN_MOMENTUM) * mean)
    s.put("var", BN_MOMENTUM * var_run + (1 - BN_MOMENTUM) * var)
  else:
    mean, var = mean_run, var_run
  y = (x - mean[None, :, None, None]) * torch.rsqrt(
      var + BN_EPS)[None, :, None, None]
  if affine:
    y = (y * s.get("scale", (c,), ("scale",))[None, :, None, None]
         + s.get("bias", (c,), ("bias",))[None, :, None, None])
  return y


def padding_mask(max_len: Tensor, total_len: int) -> Tensor:
  """``[B, L]``, 1.0 at word positions past the caption's length."""
  positions = torch.arange(total_len, device=max_len.device,
                           dtype=torch.float32)[None, :]
  return (positions >= max_len.reshape(-1, 1).float()).float()


def _diagonal_ce(logits: Tensor) -> Tensor:
  """Mean cross entropy of each row against its diagonal entry."""
  return -torch.diagonal(F.log_softmax(logits, dim=-1)).mean()


def nt_xent(s: Scope, a: Tensor, b: Tensor,
            temperature: float = 0.1) -> Tensor:
  """Symmetric InfoNCE of two aligned ``[B, D]`` sets: the sum of both
  directions' mean cross entropies."""
  a = l2_normalize(a.float())
  b = l2_normalize(b.float())
  logits = (s.r(a) @ s.r(b).t()) / temperature
  return _diagonal_ce(logits) + _diagonal_ce(logits.t())


def word_loss(s: Scope, region: Tensor, word: Tensor, max_len: Tensor,
              gamma1: float = 5.0, gamma2: float = 5.0,
              gamma3: float = 50.0) -> Tensor:
  """AttnGAN's word-region matching loss over the batch (DAMSM):
  ``region [B, R, D]``, ``word [B, L, D]``."""
  mask = padding_mask(max_len, word.shape[1])
  rn = s.r(l2_normalize(region.float()))
  wn = s.r(l2_normalize(word.float()))
  # sim[j, i, r, w]: region r of image i against word w of caption j.
  sim = torch.einsum("ird,jwd->jirw", rn, wn)
  alpha = torch.softmax(sim * gamma1 + mask[:, None, None, :] * NEG_INF,
                        dim=2)
  ctx = torch.einsum("jirw,ird->jiwd", s.r(alpha), rn)
  num = torch.einsum("jiwd,jwd->jiw", s.r(ctx), wn)
  ctx_norm = torch.rsqrt(torch.clamp_min((ctx * ctx).sum(-1), 1e-12))
  row_sim = num * ctx_norm * gamma2 + mask[:, None, :] * NEG_INF
  scores = torch.logsumexp(row_sim, dim=-1) / gamma2 * gamma3  # [cap, img]
  return _diagonal_ce(scores.t()) + _diagonal_ce(scores)


def attention_for_g(s: Scope, region: Tensor, word: Tensor, mask: Tensor,
                    gamma: float) -> Tensor:
  """Each region's context over the caption's words: ``[B, R, D]``."""
  rn = s.r(l2_normalize(region.float()))
  wn = s.r(l2_normalize(word.float()))
  logits = torch.einsum("brd,bwd->brw", rn, wn) * gamma
  attn = torch.softmax(logits + mask[:, None, :] * NEG_INF, dim=-1)
  return torch.einsum("brw,bwd->brd", s.r(attn), wn)


def hinge_d(real_logit: Tensor, fake_logit: Tensor) -> Tensor:
  return F.relu(1.0 - real_logit).mean() + F.relu(1.0 + fake_logit).mean()


def hinge_g(fake_logit: Tensor) -> Tensor:
  return -fake_logit.mean()


def bf16_rounding(x: Tensor) -> Tensor:
  """``x`` rounded to bfloat16; the gradient passes unchanged."""
  return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x).detach()


def fp8_rounding(x: Tensor) -> Tensor:
  """``x`` rounded to float8 e4m3 with one scale a tensor (its largest
  magnitude to 448), as an fp8 product would take its operands; the
  gradient passes unchanged."""
  amax = x.detach().abs().amax().float().clamp_min(1e-30)
  scale = 448.0 / amax
  q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
  return x + (q.to(x.dtype) - x).detach()

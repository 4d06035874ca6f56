"""Word-region scores: the port of the JAX package's
``ops/pallas/word_scores.py`` on one device.

`scores` gives the ``[image, caption]`` AttnGAN match scores of unit
region and word features (kernel ``scores_fwd`` of
``csrc/word_scores.cu``, the port of ``_scores_kernel``); `drn` their
gradient with respect to the regions for a cotangent of the scores
(``scores_drn_chain`` and ``scores_gemm``, the port of
``_bwd_drn_kernel``); and `dwn` the gradient with respect to the words,
summed over images (``scores_dwn_chain``, ``scores_gemm`` and
``sum_parts``, the port of ``_bwd_dwn_kernel``).  The forward kernel
takes the regions' Gram matrix ``rn rn^T`` (one batched matmul inside
`scores`) and, when a gradient will follow, saves what both gradients
start from into a `new_saved` buffer, which `drn` and `dwn` read.  All
three run their products on the tensor cores in the float32-accurate
3xTF32 split.  `drn` is three launches (the cotangent chain, ``H``, then
``d_rn`` as one product per image) and `dwn` three (the chain, one
product over images x regions in parts of that depth, the parts' sum in
a fixed order), into scratch each allocates.  For
CPU tensors each runs its plain PyTorch version (`scores_plain`,
`drn_plain`, `dwn_plain`).  `word_scores` is the public ``[caption,
image]`` op over raw features; on the card its backward gives the
gradient of each input that asks for one.  The training step asks only
for the regions': its word features are the batch's BERT embeddings.

With a ``mesh``, `word_scores` is the dispatch of the JAX package's
``make_sharded_word_scores`` (`make_sharded_word_scores` here): each
process scores its own images against every process's captions (``[B/N,
B]`` rows, kernel B at I = B/N, C = B), and the rows are gathered into
the ``[caption, image]`` matrix.  Its backward gives this process's
``d_rn`` from its columns of the cotangent (kernel C) and a partial
``d_wn`` over its images (kernel D), which one sum over processes
completes.  Without a mesh the same autograd Function runs on the whole
batch with no collective; on CPU tensors with a mesh it runs the plain
versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xmcgan_image_generation_tpu_torch.ops.contrastive import l2_normalize
from xmcgan_image_generation_tpu_torch.ops.cuda import build
from xmcgan_image_generation_tpu_torch.parallel import collectives

NEG_INF = -1e9
MAX_REGIONS = 256   # the kernels' limit on regions per image


def scores_plain(rn: torch.Tensor, wn: torch.Tensor, mask: torch.Tensor,
                 gamma1: float, gamma2: float) -> torch.Tensor:
  """The plain version of kernel ``scores_fwd``: ``[image, caption]``."""
  sim = torch.einsum("ird,cwd->icrw", rn, wn)
  logits = sim * gamma1 + mask[None, :, None, :] * NEG_INF
  alpha = F.softmax(logits, dim=2)                       # over regions
  ctx = torch.einsum("icrw,ird->icwd", alpha, rn)
  num = torch.einsum("icwd,cwd->icw", ctx, wn)
  csq = (ctx * ctx).sum(dim=-1)
  rowsim = num * torch.rsqrt(torch.clamp_min(csq, 1e-12))
  row = rowsim * gamma2 + mask[None] * NEG_INF
  return torch.logsumexp(row, dim=-1) / gamma2


def drn_plain(rn: torch.Tensor, wn: torch.Tensor, mask: torch.Tensor,
              g: torch.Tensor, gamma1: float, gamma2: float) -> torch.Tensor:
  """The plain version of kernel C (`drn`): the gradient of
  ``sum(g * scores_plain(rn, wn, mask).T)`` with respect to ``rn``.

  ``g`` is ``[caption, image]``, the layout of the public scores.
  """
  with torch.enable_grad():
    x = rn.detach().requires_grad_()
    s = scores_plain(x, wn.detach(), mask, gamma1, gamma2)
    (d_rn,) = torch.autograd.grad(s, x, g.t())
  return d_rn


def dwn_plain(rn: torch.Tensor, wn: torch.Tensor, mask: torch.Tensor,
              g: torch.Tensor, gamma1: float, gamma2: float) -> torch.Tensor:
  """The plain version of kernel D (`dwn`): the gradient of
  ``sum(g * scores_plain(rn, wn, mask).T)`` with respect to ``wn``."""
  with torch.enable_grad():
    y = wn.detach().requires_grad_()
    s = scores_plain(rn.detach(), y, mask, gamma1, gamma2)
    (d_wn,) = torch.autograd.grad(s, y, g.t())
  return d_wn


def _check(rn, wn, mask, g=None) -> None:
  tensors = [rn, wn, mask] + ([g] if g is not None else [])
  if any(t.dtype != torch.float32 for t in tensors):
    raise TypeError("word_scores kernels take float32 tensors")
  if any(t.device != rn.device for t in tensors):
    raise ValueError("word_scores inputs lie on different devices")
  if any(not t.is_contiguous() for t in tensors):
    raise ValueError("word_scores inputs must be contiguous")
  if rn.dim() != 3 or wn.dim() != 3 or rn.shape[2] != wn.shape[2]:
    raise ValueError(f"regions [I, R, D] and words [C, L, D] expected, got "
                     f"{tuple(rn.shape)} and {tuple(wn.shape)}")
  if tuple(mask.shape) != tuple(wn.shape[:2]):
    raise ValueError(f"mask {tuple(mask.shape)} does not match words "
                     f"{tuple(wn.shape)}")
  if g is not None and tuple(g.shape) != (wn.shape[0], rn.shape[0]):
    raise ValueError(f"cotangent {tuple(g.shape)} is not [caption, image]")


def _kernel_shape(rn, wn):
  """(lib, group) for a launch on the card, or raises."""
  if rn.device.type != "cuda":
    raise ValueError(f"word_scores has no kernel for {rn.device}")
  lib = build.library()
  group = lib.xmc_word_scores_group_size(wn.shape[1])
  if rn.shape[1] > MAX_REGIONS or group < 1 or rn.shape[2] % 4:
    raise ValueError(f"word_scores kernels take at most 256 regions, 72 "
                     f"words per caption and a feature size divisible by 4, "
                     f"got {tuple(rn.shape)} and {tuple(wn.shape)}")
  return lib, group


def _check_saved(rn: torch.Tensor, wn: torch.Tensor,
                 saved: torch.Tensor) -> None:
  want = _saved_shape(rn, wn)
  if (not isinstance(saved, torch.Tensor) or tuple(saved.shape) != want
      or saved.dtype != torch.float32 or saved.device != rn.device
      or not saved.is_contiguous()):
    raise ValueError(f"saved must be a contiguous float32 tensor of shape "
                     f"{want} beside the regions")


def _saved_shape(rn: torch.Tensor, wn: torch.Tensor):
  lib, group = _kernel_shape(rn, wn)
  return (rn.shape[0], -(-wn.shape[0] // group),
          lib.xmc_word_scores_record_floats())


def new_saved(rn: torch.Tensor, wn: torch.Tensor) -> torch.Tensor:
  """An empty buffer for what `scores` saves for `drn` and `dwn` (on the
  card):
  alpha, S and G alpha of every (image, caption group)."""
  return torch.empty(_saved_shape(rn, wn), dtype=torch.float32,
                     device=rn.device)


def scores(rn: torch.Tensor, wn: torch.Tensor, mask: torch.Tensor,
           gamma1: float = 5.0, gamma2: float = 5.0,
           saved: torch.Tensor = None) -> torch.Tensor:
  """``[image, caption]`` scores of unit features: kernel or plain (CPU).

  ``saved``, a `new_saved` buffer, receives what `drn` and `dwn` need for
  the same inputs.
  """
  _check(rn, wn, mask)
  if rn.device.type == "cpu":
    return scores_plain(rn, wn, mask, gamma1, gamma2)
  lib, _ = _kernel_shape(rn, wn)
  if saved is not None:
    _check_saved(rn, wn, saved)
  num_images, regions, dim = rn.shape
  num_caps, words, _ = wn.shape
  # The kernel reads the Gram matrix in rows of 16 bytes: zero regions pad
  # it to a multiple of 4.
  gram_ld = -(-regions // 4) * 4
  rn_g = rn if gram_ld == regions else F.pad(rn, (0, 0, 0, gram_ld - regions))
  rn_gram = torch.bmm(rn_g, rn_g.transpose(1, 2))  # TF32 if the caller allows
  out = torch.empty((num_images, num_caps), dtype=torch.float32,
                    device=rn.device)
  status = lib.xmc_word_scores_fwd(
      rn.data_ptr(), wn.data_ptr(), mask.data_ptr(), rn_gram.data_ptr(),
      out.data_ptr(), saved.data_ptr() if saved is not None else None,
      num_images, num_caps, regions, words, dim, gram_ld, float(gamma1),
      float(gamma2), torch.cuda.current_stream(rn.device).cuda_stream)
  build.check(status, "word_scores forward kernel")
  scores.launches += 1
  return out


scores.launches = 0


def drn(rn: torch.Tensor, wn: torch.Tensor, mask: torch.Tensor,
        g: torch.Tensor, saved: torch.Tensor, gamma1: float = 5.0,
        gamma2: float = 5.0) -> torch.Tensor:
  """Gradient of the scores with respect to ``rn`` for a ``[caption,
  image]`` cotangent ``g``: kernel or plain (CPU).

  ``saved`` is the buffer `scores` filled for the same inputs; the plain
  version recomputes instead and ignores it.
  """
  _check(rn, wn, mask, g)
  if rn.device.type == "cpu":
    return drn_plain(rn, wn, mask, g, gamma1, gamma2)
  lib, _ = _kernel_shape(rn, wn)
  _check_saved(rn, wn, saved)
  num_images, regions, dim = rn.shape
  num_caps, words, _ = wn.shape
  # Per image, the operands [E | -H] ([256, word rows + 256]) and F = cb
  # alpha ([256, word rows]) of the kernel's two products.
  rows = lib.xmc_word_scores_word_rows(num_caps, words)
  ops = torch.empty((num_images, MAX_REGIONS, rows + MAX_REGIONS),
                    dtype=torch.float32, device=rn.device)
  fbuf = torch.empty((num_images, MAX_REGIONS, rows), dtype=torch.float32,
                     device=rn.device)
  d_rn = torch.empty_like(rn)
  status = lib.xmc_word_scores_drn(
      rn.data_ptr(), wn.data_ptr(), mask.data_ptr(), g.data_ptr(),
      saved.data_ptr(), ops.data_ptr(), fbuf.data_ptr(), d_rn.data_ptr(),
      num_images, num_caps, regions, words, dim, float(gamma1),
      float(gamma2), torch.cuda.current_stream(rn.device).cuda_stream)
  build.check(status, "word_scores region-gradient kernel")
  drn.launches += 1
  return d_rn


drn.launches = 0


def dwn(rn: torch.Tensor, wn: torch.Tensor, mask: torch.Tensor,
        g: torch.Tensor, saved: torch.Tensor, gamma1: float = 5.0,
        gamma2: float = 5.0) -> torch.Tensor:
  """Gradient of the scores with respect to ``wn`` for a ``[caption,
  image]`` cotangent ``g``, summed over images: kernel or plain (CPU).

  ``saved`` is the buffer `scores` filled for the same inputs; the plain
  version recomputes instead and ignores it.
  """
  _check(rn, wn, mask, g)
  if rn.device.type == "cpu":
    return dwn_plain(rn, wn, mask, g, gamma1, gamma2)
  lib, _ = _kernel_shape(rn, wn)
  _check_saved(rn, wn, saved)
  num_images, regions, dim = rn.shape
  num_caps, words, _ = wn.shape
  # E's [word row][region] planes per (image, caption group); the product
  # splits its depth (images x regions) into parts, each summed into its
  # own partial, which a third launch adds in a fixed order.
  rows = lib.xmc_word_scores_word_rows(num_caps, words)
  ebuf = torch.empty((num_images, rows, MAX_REGIONS), dtype=torch.float32,
                     device=rn.device)
  sms = torch.cuda.get_device_properties(rn.device).multi_processor_count
  parts = lib.xmc_word_scores_dwn_parts(num_images, num_caps, regions, words,
                                        dim, sms)
  d_wn = torch.empty_like(wn)
  partial = (d_wn if parts == 1 else
             torch.empty((parts,) + tuple(wn.shape), dtype=torch.float32,
                         device=rn.device))
  status = lib.xmc_word_scores_dwn(
      rn.data_ptr(), mask.data_ptr(), g.data_ptr(), saved.data_ptr(),
      ebuf.data_ptr(), partial.data_ptr(), d_wn.data_ptr(), num_images,
      num_caps, regions, words, dim, parts, float(gamma1), float(gamma2),
      torch.cuda.current_stream(rn.device).cuda_stream)
  build.check(status, "word_scores word-gradient kernel")
  dwn.launches += 1
  return d_wn


dwn.launches = 0


def _unit_with_vjp(feat: torch.Tensor):
  """``(x, unit)``: a leaf copy of ``feat`` and its l2-normalized float32
  rows, with the graph between them for the normalization's VJP."""
  with torch.enable_grad():
    x = feat.detach().requires_grad_()
    return x, l2_normalize(x.float(), dim=-1)


def _gather(x: torch.Tensor, mesh, tag: str) -> torch.Tensor:
  """Every process's rows of ``x``; ``x`` itself without a mesh (not the
  ambient one: the caller chose none)."""
  return x if mesh is None else collectives.gather_rows(x, mesh, tag=tag)


class _WordScores(torch.autograd.Function):
  """Scores and both gradients of this process's images against every
  process's captions (see the module's docstring); with no mesh, of the
  whole batch against itself."""

  @staticmethod
  def forward(ctx, region_feat, word_feat, mask, mesh, gamma1, gamma2):
    rn = l2_normalize(region_feat.float(), dim=-1).contiguous()
    wn = _gather(l2_normalize(word_feat.float(), dim=-1), mesh,
                 "word_features").contiguous()
    mask = _gather(mask, mesh, "word_mask").contiguous()
    saved = (new_saved(rn, wn) if rn.device.type == "cuda"
             and any(ctx.needs_input_grad[:2]) else None)
    rows = scores(rn, wn, mask, gamma1, gamma2, saved=saved)    # [B/N, B]
    out = _gather(rows, mesh, "word_scores")
    ctx.save_for_backward(region_feat, word_feat, wn, mask, saved)
    ctx.rank = 0 if mesh is None else mesh.rank
    ctx.mesh, ctx.gammas = mesh, (gamma1, gamma2)
    return out.t().contiguous()

  @staticmethod
  def backward(ctx, g):
    region_feat, word_feat, wn, mask, saved = ctx.saved_tensors
    need_region, need_word = ctx.needs_input_grad[:2]
    local = region_feat.shape[0]
    start = ctx.rank * local
    # Every process computed the same loss: g is whole on each, and this
    # process's images are its columns.
    g = g.float()[:, start:start + local].contiguous()
    x, rn = _unit_with_vjp(region_feat)
    rn_d = rn.detach().contiguous()
    d_region = d_word = None
    if need_region:
      d_rn = drn(rn_d, wn, mask, g, saved, *ctx.gammas)
      (d_region,) = torch.autograd.grad(rn, x, d_rn)
    if need_word:
      d_wn = dwn(rn_d, wn, mask, g, saved, *ctx.gammas)
      if ctx.mesh is not None:
        d_wn = collectives.all_reduce(d_wn, mesh=ctx.mesh, tag="word_grad")
      y, wn_local = _unit_with_vjp(word_feat)
      (d_word,) = torch.autograd.grad(wn_local, y,
                                      d_wn[start:start + local])
    return d_region, d_word, None, None, None, None


def word_scores(region_feat: torch.Tensor, word_feat: torch.Tensor,
                mask: torch.Tensor, gamma1: float = 5.0,
                gamma2: float = 5.0, mesh=None) -> torch.Tensor:
  """``[caption, image]`` match scores (before the gamma3 scale).

  ``region_feat`` ``[B, R, D]``, ``word_feat`` ``[B, L, D]``, ``mask``
  ``[B, L]`` with 1.0 at padding words; normalization happens inside.
  With a ``mesh`` (a `parallel.mesh.ProcessMesh` with a group) each
  argument holds this process's rows and the result is the global
  matrix, the same on every process.  On the CPU without a mesh the
  plain version's autograd gives both gradients.
  """
  mask = mask.float().contiguous()
  if region_feat.device.type == "cpu" and mesh is None:
    rn = l2_normalize(region_feat.float(), dim=-1).contiguous()
    wn = l2_normalize(word_feat.float(), dim=-1).contiguous()
    return scores(rn, wn, mask, gamma1, gamma2).t()
  return _WordScores.apply(region_feat, word_feat, mask, mesh,
                           float(gamma1), float(gamma2))


def make_sharded_word_scores(mesh, gamma1: float = 5.0,
                             gamma2: float = 5.0):
  """``(region_feat, word_feat, mask) -> [caption, image]`` scores over
  ``mesh``'s processes (the JAX package's ``make_sharded_word_scores``):
  `word_scores` with the mesh."""

  def sharded(region_feat: torch.Tensor, word_feat: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    return word_scores(region_feat, word_feat, mask, gamma1, gamma2,
                       mesh=mesh)

  return sharded

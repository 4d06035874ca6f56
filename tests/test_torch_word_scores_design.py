"""The design of the tensor-core word-score kernels (``csrc/word_scores.cu``
``scores_fwd``, ``scores_drn_chain`` and ``scores_dwn_chain`` with
``scores_gemm``), checked on the CPU.

The kernels cannot run here, so these tests hold a plain PyTorch model of
their arithmetic, step by step in their layouts:

1. kernel B's record (alpha, S and G alpha as ``[word][region]`` planes
   per image and caption group of 72 word rows, then ctx.wn and |ctx|^2),
   and kernel C's decomposition of the region gradient: the cotangent
   chain gives E and F = cb alpha, then H = F^T alpha, then d_rn =
   [E ; -H]^T [wn ; rn] as one product per image.  At a small ragged size
   the model agrees with the JAX package's ``_scores_bwd_pallas`` (run in
   interpret mode) and with `drn_plain`.
2. The same model with every product emulated as the card runs it: the
   operands rounded to TF32 (round to nearest, ties away, by masking the
   low 13 bits), in the 3xTF32 split, accumulated in float32.  At the
   flagship's R = 256, L = 17, D = 768 it stays within 1e-5 of the largest
   |d_rn| of a float64 reference, ten times inside the card's tolerance of
   1e-4, on random and on peaked inputs, where single-pass TF32 does not.
3. Kernel D's decomposition of the word gradient: E as [word row][region]
   planes, d_wn^T = sum over images x regions of rn^T E^T in stages of 64
   (each summed fresh, then added to a float32 total), the stages split
   into parts of consecutive stages whose totals are added in a fixed
   order.  It agrees with the JAX package's word gradient and `dwn_plain`
   at a small ragged size for several part counts, and in the emulated
   3xTF32 split over the flagship's depth K = 56 images x 256 regions =
   14336 it stays within 1e-5 of the largest |d_wn| of a float64
   reference (the card's tolerance is 1e-4).
"""

import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu_torch.ops.contrastive import l2_normalize
from xmcgan_image_generation_tpu_torch.ops.cuda import word_scores as ws

try:
  import jax.numpy as jnp
  from xmcgan_image_generation_tpu.ops.pallas import word_scores as ws_pl
except ImportError:  # The GPU machine has no JAX.
  jnp = None

torch.set_num_threads(1)

GAMMA = 5.0
MAX_WORDS = 72   # word rows of a caption group in the kernels


# ---------------------------------------------------------------------------
# Products: exact float32, and the card's TF32 passes.
# ---------------------------------------------------------------------------


def mm_f32(a, b):
  return a @ b


def tf32(x: torch.Tensor) -> torch.Tensor:
  """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
  from zero, as ``cvt.rna.tf32.f32`` does."""
  bits = x.contiguous().view(torch.int32)
  return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_tf32x3(a, b):
  """The 3xTF32 split: small_a big_b + big_a small_b + big_a big_b, each
  product of two TF32 values exact in the float32 sum."""
  a_big, b_big = tf32(a), tf32(b)
  a_small, b_small = tf32(a - a_big), tf32(b - b_big)
  return (torch.cat([a_small, a_big, a_big], -1)
          @ torch.cat([b_big, b_small, b_big], -2))


def mm_tf32(a, b):
  return tf32(a) @ tf32(b)


# ---------------------------------------------------------------------------
# The kernels' arithmetic in their layouts.
# ---------------------------------------------------------------------------


def _caption_groups(wn, mask):
  """Words and mask of each caption group as the kernels lay them out:
  [groups, 72, D] and [groups, 72], zero rows past the group's words, and
  the caption of each row (-1 past them)."""
  num_caps, words, dim = wn.shape
  group = MAX_WORDS // words
  num_groups = -(-num_caps // group)
  wp = wn.new_zeros(num_groups, MAX_WORDS, dim)
  mp = mask.new_zeros(num_groups, MAX_WORDS)
  cap = torch.full((num_groups, MAX_WORDS), -1, dtype=torch.long)
  for grp in range(num_groups):
    caps = range(grp * group, min(num_caps, (grp + 1) * group))
    n = len(caps) * words
    wp[grp, :n] = wn[caps.start:caps.stop].reshape(n, dim)
    mp[grp, :n] = mask[caps.start:caps.stop].reshape(n)
    cap[grp, :n] = torch.arange(caps.start, caps.stop).repeat_interleave(
        words)
  return wp, mp, cap


def _row_logits(num, csq, mp, gamma2):
  return (num * torch.rsqrt(torch.clamp_min(csq, 1e-12)) * gamma2
          + mp * ws.NEG_INF)


def _caption_lse(row, cap, num_caps):
  """[I, C]: logsumexp over each caption's word rows."""
  return torch.stack([torch.logsumexp(row[:, cap == c], dim=-1)
                      for c in range(num_caps)], dim=-1)


def record(rn, wn, mask, gamma1, mm):
  """Kernel B's record: alpha, S, G alpha [I, groups, 72, R] and ctx.wn,
  |ctx|^2 [I, groups, 72], with the products S = rn wn^T and G alpha
  taken by ``mm`` (the Gram matrix comes from float32 cuBLAS)."""
  wp, mp, cap = _caption_groups(wn, mask)
  sim = mm(rn[:, None], wp.transpose(1, 2)[None])          # [I, G, R, 72]
  alpha = torch.softmax(sim * gamma1 + mp[None, :, None] * ws.NEG_INF,
                        dim=2) * (cap >= 0)[None, :, None]
  gram = rn @ rn.transpose(1, 2)
  p = mm(gram[:, None], alpha)                             # G alpha
  num = (alpha * sim).sum(2)
  csq = (alpha * p).sum(2)
  planes = [x.transpose(2, 3) for x in (alpha, sim, p)]
  return planes, num, csq


def scores_from_record(num, csq, mask, num_caps, gamma2):
  """Kernel B's output [image, caption] from its record."""
  _, mp, cap = _caption_groups(num.new_zeros(num_caps, mask.shape[1], 1),
                               mask)
  row = _row_logits(num, csq, mp[None], gamma2).flatten(1)
  return _caption_lse(row, cap.flatten(), num_caps) / gamma2


def chain(rn, wn, mask, g, gamma1, gamma2, mm):
  """The cotangent chain of kernels C and D from kernel B's record: E =
  ca alpha + d_sim and F = cb alpha as [I, groups, 72, R] planes (zero past
  a group's words), and alpha; the record's products taken by ``mm``, the
  rest in the inputs' precision."""
  num_caps = wn.shape[0]
  (alpha, sim, p), num, csq = record(rn, wn, mask, gamma1, mm)
  _, mp, cap = _caption_groups(wn, mask)
  # The logsumexp VJP, then the cosine VJP: d_ctx = ca wn - cb ctx.
  row = _row_logits(num, csq, mp[None], gamma2)            # [I, G, 72]
  lse = _caption_lse(row.flatten(1), cap.flatten(), num_caps)
  real = cap >= 0
  capc = cap.clamp_min(0)
  beta = torch.exp(row - lse[:, capc]) * real
  d_rowsim = g.t()[:, capc] * beta
  inv = torch.rsqrt(torch.clamp_min(csq, 1e-12))
  ca = d_rowsim * inv
  cb = (csq >= 1e-12) * d_rowsim * num * inv * inv * inv
  # The softmax VJP of d_alpha = ca S - cb G alpha.
  t = alpha * (ca[..., None] * sim - cb[..., None] * p)
  e = alpha * ca[..., None] + gamma1 * (t - alpha * t.sum(-1, keepdim=True))
  f = alpha * cb[..., None]
  return e, f, alpha


def drn_decomposed(rn, wn, mask, g, gamma1, gamma2, mm):
  """Kernel C: the chain gives E = ca alpha + d_sim and F = cb alpha, then
  H = F^T alpha, then d_rn = [E ; -H]^T [wn ; rn] per image, every product
  taken by ``mm``, the rest in the inputs' precision."""
  num_images, regions, dim = rn.shape
  e, f, alpha = chain(rn, wn, mask, g, gamma1, gamma2, mm)
  wp, _, _ = _caption_groups(wn, mask)
  kp = wp.shape[0] * MAX_WORDS
  e, f, a = (x.reshape(num_images, kp, regions) for x in (e, f, alpha))
  h = mm(f.transpose(1, 2), a)                             # [I, R, R]
  ops = torch.cat([e, -h], dim=1)                          # [I, kp + R, R]
  rhs = torch.cat([wp.reshape(1, kp, dim).expand(num_images, kp, dim), rn],
                  dim=1)
  return mm(ops.transpose(1, 2), rhs)


def dwn_decomposed(rn, wn, mask, g, gamma1, gamma2, mm, parts, stage=64):
  """Kernel D: E's [word row][region] planes from the chain, then d_wn^T =
  sum over the depth k = image x R + region of rn[k]^T E[k]^T, taken by
  ``mm`` in stages of ``stage``: each stage's product is a fresh sum that
  joins its part's float32 total, part p holds the p-th of ``parts`` runs
  of consecutive stages, and the parts' totals are added in the order
  p = 0, 1, ...  Returns d_wn [C, L, D] from the real word rows."""
  num_images, regions, dim = rn.shape
  num_caps, words, _ = wn.shape
  e, _, _ = chain(rn, wn, mask, g, gamma1, gamma2, mm)
  rows = e.shape[1] * MAX_WORDS
  a = rn.reshape(num_images * regions, dim)                # [K, D]
  b = e.permute(0, 3, 1, 2).reshape(num_images * regions, rows)  # [K, n]
  stages = -(-a.shape[0] // stage)
  total = torch.zeros(dim, rows)
  for p in range(parts):
    part = torch.zeros(dim, rows)
    for s in range(p * stages // parts, (p + 1) * stages // parts):
      k = slice(s * stage, (s + 1) * stage)
      part = part + mm(a[k].t(), b[k])
    total = total + part
  _, _, cap = _caption_groups(wn, mask)
  return total.t()[cap.flatten() >= 0].reshape(num_caps, words, dim)


# ---------------------------------------------------------------------------
# Inputs.
# ---------------------------------------------------------------------------


def _inputs(seed, num_images, num_caps, regions, words, dim, kind):
  """Unit regions and words, a ragged mask and a cotangent from a numpy
  seed.  ``peaked``: each region is 3 x a real word of its caption (image
  i pairs with caption i modulo the captions) plus 0.5 x noise, which gives sharp alpha and
  |S| near 1, as trained features do."""
  rng = np.random.default_rng(seed)
  word = rng.standard_normal((num_caps, words, dim)).astype(np.float32)
  max_len = rng.integers(2, words + 1, (num_caps, 1))
  mask = (np.arange(words)[None, :] >= max_len).astype(np.float32)
  if kind == "random":
    region = rng.standard_normal((num_images, regions, dim))
  else:
    own = np.arange(num_images) % num_caps
    pick = (rng.random((num_images, regions))
            * max_len[own]).astype(np.int64)
    region = (3 * word[own[:, None], pick]
              + 0.5 * rng.standard_normal((num_images, regions, dim)))
  g = rng.standard_normal((num_caps, num_images)).astype(np.float32)
  rn = l2_normalize(torch.from_numpy(region.astype(np.float32)))
  wn = l2_normalize(torch.from_numpy(word))
  return rn, wn, torch.from_numpy(mask), torch.from_numpy(g)


# ---------------------------------------------------------------------------
# Tests.
# ---------------------------------------------------------------------------


def test_decomposition_matches_pallas_and_plain():
  """The kernels' decomposition in float32 against the JAX package's
  region gradient (interpret mode) and `drn_plain`: three caption groups,
  the last one short, a ragged mask, more captions than images.
  Tolerance: float32 on all sides, other summation orders -> 1e-5 of the
  largest |d_rn| (the port's kernel tests allow 1e-4)."""
  if jnp is None:
    pytest.skip("the JAX reference package is not installed")
  rn, wn, mask, g = _inputs(0, 5, 7, 16, 20, 32, "random")
  got = drn_decomposed(rn, wn, mask, g, GAMMA, GAMMA, mm_f32)
  want, _ = ws_pl._scores_bwd_pallas(
      jnp.asarray(rn.numpy()), jnp.asarray(wn.numpy()),
      jnp.asarray(mask.numpy()), jnp.asarray(g.numpy()), GAMMA, GAMMA,
      interpret=True)
  want = np.asarray(want)
  tol = 1e-5 * np.abs(want).max()
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
  plain = ws.drn_plain(rn, wn, mask, g, GAMMA, GAMMA)
  np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=tol)
  # Kernel B's output from its record, against the plain forward.
  (_, _, _), num, csq = record(rn, wn, mask, GAMMA, mm_f32)
  np.testing.assert_allclose(
      scores_from_record(num, csq, mask, wn.shape[0], GAMMA).numpy(),
      ws.scores_plain(rn, wn, mask, GAMMA, GAMMA).numpy(), rtol=0,
      atol=1e-6)


@pytest.mark.parametrize("kind", ["random", "peaked"])
def test_tf32x3_keeps_float32_accuracy(kind):
  """Every product of kernels B and C in the emulated 3xTF32 split, at the
  flagship's R, L and D: d_rn within 1e-5 of the largest |d_rn| of the
  float64 reference (ten times inside the card's 1e-4), the scores within
  1e-5 (B's tolerance is 1e-4).  Single-pass TF32 misses the gradient's
  bound, which shows that the emulation rounds."""
  rn, wn, mask, g = _inputs(1, 3, 3, 256, 17, 768, kind)
  want = ws.drn_plain(rn.double(), wn.double(), mask.double(), g.double(),
                      GAMMA, GAMMA)
  scale = float(want.abs().max())
  got = drn_decomposed(rn, wn, mask, g, GAMMA, GAMMA, mm_tf32x3)
  err = float((got.double() - want).abs().max()) / scale
  assert err <= 1e-5, err
  single = drn_decomposed(rn, wn, mask, g, GAMMA, GAMMA, mm_tf32)
  assert float((single.double() - want).abs().max()) / scale > 1e-5
  (_, _, _), num, csq = record(rn, wn, mask, GAMMA, mm_tf32x3)
  scores = scores_from_record(num, csq, mask, wn.shape[0], GAMMA)
  scores_want = ws.scores_plain(rn.double(), wn.double(), mask.double(),
                                GAMMA, GAMMA)
  assert float((scores.double() - scores_want).abs().max()) <= 1e-5


@pytest.mark.parametrize("parts", [1, 3, 10])
def test_dwn_decomposition_matches_pallas_and_plain(parts):
  """Kernel D's decomposition in float32, in stages of 8 over K = 5 x 16
  and 1, 3 or 10 parts, against the JAX package's word gradient
  (interpret mode) and `dwn_plain`: three caption groups, the last one
  short, a ragged mask, more captions than images.  Tolerance: float32 on
  all sides, other summation orders -> 1e-5 of the largest |d_wn| (the
  port's kernel tests allow 1e-4)."""
  if jnp is None:
    pytest.skip("the JAX reference package is not installed")
  rn, wn, mask, g = _inputs(2, 5, 7, 16, 20, 32, "random")
  got = dwn_decomposed(rn, wn, mask, g, GAMMA, GAMMA, mm_f32, parts, stage=8)
  _, want = ws_pl._scores_bwd_pallas(
      jnp.asarray(rn.numpy()), jnp.asarray(wn.numpy()),
      jnp.asarray(mask.numpy()), jnp.asarray(g.numpy()), GAMMA, GAMMA,
      interpret=True)
  want = np.asarray(want)
  tol = 1e-5 * np.abs(want).max()
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
  plain = ws.dwn_plain(rn, wn, mask, g, GAMMA, GAMMA)
  np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("kind", ["random", "peaked"])
def test_dwn_tf32x3_keeps_float32_accuracy(kind):
  """Kernel D with every product in the emulated 3xTF32 split (the record's
  too), over the flagship's depth K = 56 images x 256 regions = 14336 at
  L = 17, D = 768, in the card's stages of 64 and its 8 parts: d_wn within
  1e-5 of the largest |d_wn| of the float64 reference, ten times inside
  the card's tolerance of 1e-4 (3.6e-5 at the flagship).  Single-pass
  TF32 misses that bound, which shows that the emulation rounds."""
  rn, wn, mask, g = _inputs(3, 56, 4, 256, 17, 768, kind)
  want = ws.dwn_plain(rn.double(), wn.double(), mask.double(), g.double(),
                      GAMMA, GAMMA)
  scale = float(want.abs().max())
  got = dwn_decomposed(rn, wn, mask, g, GAMMA, GAMMA, mm_tf32x3, parts=8)
  err = float((got.double() - want).abs().max()) / scale
  assert err <= 1e-5, err
  single = dwn_decomposed(rn, wn, mask, g, GAMMA, GAMMA, mm_tf32, parts=8)
  assert float((single.double() - want).abs().max()) / scale > 1e-5


def test_tf32_rounding():
  """``tf32`` keeps 10 mantissa bits and rounds half away from zero."""
  one = 1.0
  ulp = 2.0 ** -10
  x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -20,
                    3.0, one + ulp])
  np.testing.assert_array_equal(
      tf32(x).numpy(),
      np.float32([one + ulp, -(one + ulp), one, 3.0, one + ulp]))

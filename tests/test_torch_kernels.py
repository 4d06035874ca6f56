"""The port's kernels (ops/cuda) against the JAX package's Pallas kernels.

CPU tests: the plain PyTorch version of each kernel (NT-Xent, word-score
forward, word-score region and word gradients) against the Pallas kernel
run in interpret mode, at a small size with a ragged mask, for float32
and for bfloat16 inputs.  Inputs come from a numpy seed.

GPU tests (marker ``gpu``): each CUDA kernel against its plain version at
the flagship shapes.  They need a card and skip without one; on the card
run ``python -m pytest -m gpu --noconftest tests/test_torch_kernels.py``
(the JAX package is not needed there).
"""

import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu_torch.ops import attention
from xmcgan_image_generation_tpu_torch.ops.attention import padding_mask
from xmcgan_image_generation_tpu_torch.ops.contrastive import l2_normalize
from xmcgan_image_generation_tpu_torch.ops.cuda import ntxent
from xmcgan_image_generation_tpu_torch.ops.cuda import word_scores as ws

try:
  import jax
  import jax.numpy as jnp
  from xmcgan_image_generation_tpu.ops import attention as jax_attention
  from xmcgan_image_generation_tpu.ops.pallas import ntxent as ntxent_pl
  from xmcgan_image_generation_tpu.ops.pallas import word_scores as ws_pl
except ImportError:  # The GPU machine has no JAX; the gpu tests need none.
  jax = None

torch.set_num_threads(1)

GAMMA = 5.0


@pytest.fixture
def reference():
  if jax is None:
    pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device("cuda")


def _to_both(x: np.ndarray, dtype: str):
  """The same values as a jnp array and a torch tensor of ``dtype``."""
  t = torch.from_numpy(x)
  j = jnp.asarray(x)
  if dtype == "bfloat16":
    t = t.to(torch.bfloat16)
    j = j.astype(jnp.bfloat16)
  return j, t


def _features(seed=0, batch=4, regions=16, words=5, dim=32):
  rng = np.random.default_rng(seed)
  region = rng.standard_normal((batch, regions, dim)).astype(np.float32)
  word = rng.standard_normal((batch, words, dim)).astype(np.float32)
  # Ragged: captions of 2..words real words.
  max_len = rng.integers(2, words + 1, (batch, 1)).astype(np.float32)
  mask = (np.arange(words)[None, :] >= max_len).astype(np.float32)
  g = rng.standard_normal((batch, batch)).astype(np.float32)
  return region, word, mask, g


# Tolerances: float32 math on both sides, different summation orders and
# XLA:CPU vs PyTorch kernels -> 1e-5 relative.  With bfloat16 inputs both
# sides cast the same bf16 values to f32 first, so the forward keeps the
# f32 tolerance; a gradient returned in bf16 may differ by one bf16 ulp
# (2^-8 relative).
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 8e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ntxent_plain_matches_pallas(reference, dtype):
  rng = np.random.default_rng(1)
  a = rng.standard_normal((8, 32)).astype(np.float32)
  b = rng.standard_normal((8, 32)).astype(np.float32)
  ja, ta = _to_both(a, dtype)
  jb, tb = _to_both(b, dtype)
  want = np.asarray(ntxent_pl.nt_xent_fused(ja, jb, 0.1, True))
  got = ntxent.ntxent_plain(ta, tb, 0.1).numpy()
  np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
  # The CPU wrapper is the plain version.
  np.testing.assert_array_equal(ntxent.ntxent_stats(ta, tb, 0.1).numpy(),
                                got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ntxent_gradient_matches_pallas(reference, dtype):
  rng = np.random.default_rng(2)
  a = rng.standard_normal((8, 32)).astype(np.float32)
  b = rng.standard_normal((8, 32)).astype(np.float32)
  ja, ta = _to_both(a, dtype)
  jb, tb = _to_both(b, dtype)
  want_a, want_b = jax.grad(
      lambda x, y: ntxent_pl.nt_xent_fused(x, y, 0.1, True)[0] * 3.0,
      argnums=(0, 1))(ja, jb)
  ta.requires_grad_()
  tb.requires_grad_()
  loss, _, _ = ntxent.nt_xent_fused(ta, tb, 0.1)
  (loss * 3.0).backward()
  for got, want in ((ta.grad, want_a), (tb.grad, want_b)):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=GRAD_RTOL[dtype],
        atol=GRAD_RTOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_word_scores_plain_matches_pallas(reference, dtype):
  region, word, mask, _ = _features(seed=3)
  jr, tr = _to_both(region, dtype)
  want = np.asarray(ws_pl.word_scores(jr, jnp.asarray(word),
                                      jnp.asarray(mask), GAMMA, GAMMA, True))
  mask_t = torch.from_numpy(mask)
  got = ws.word_scores(tr, torch.from_numpy(word), mask_t, GAMMA, GAMMA)
  np.testing.assert_allclose(got.numpy(), want, rtol=FWD_RTOL,
                             atol=FWD_ATOL)
  rn = l2_normalize(tr.float()).contiguous()
  wn = l2_normalize(torch.from_numpy(word)).contiguous()
  np.testing.assert_allclose(
      ws.scores_plain(rn, wn, mask_t, GAMMA, GAMMA).t().numpy(), want,
      rtol=FWD_RTOL, atol=FWD_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_word_scores_region_gradient_matches_pallas(reference, dtype):
  region, word, mask, g = _features(seed=4)
  jr, tr = _to_both(region, dtype)
  jw, jm, jg = jnp.asarray(word), jnp.asarray(mask), jnp.asarray(g)
  want = np.asarray(jax.grad(lambda r: jnp.sum(
      jg * ws_pl.word_scores(r, jw, jm, GAMMA, GAMMA, True)))(jr),
                    np.float32)
  tr.requires_grad_()
  s = ws.word_scores(tr, torch.from_numpy(word), torch.from_numpy(mask),
                     GAMMA, GAMMA)
  s.backward(torch.from_numpy(g))
  np.testing.assert_allclose(tr.grad.float().numpy(), want,
                             rtol=GRAD_RTOL[dtype],
                             atol=GRAD_RTOL[dtype] * np.abs(want).max())


def test_drn_plain_matches_pallas_backward(reference):
  """The plain version of kernel C against ``_scores_bwd_pallas``'s d_rn
  (unit features in, before the l2-norm VJP)."""
  region, word, mask, g = _features(seed=5)
  rn = np.array(ws_pl.l2_normalize(jnp.asarray(region), axis=-1))
  wn = np.array(ws_pl.l2_normalize(jnp.asarray(word), axis=-1))
  want, _ = ws_pl._scores_bwd_pallas(
      jnp.asarray(rn), jnp.asarray(wn), jnp.asarray(mask), jnp.asarray(g),
      GAMMA, GAMMA, interpret=True)
  want = np.asarray(want)
  args = [torch.from_numpy(x) for x in (rn, wn, mask, g)]
  got = ws.drn_plain(*args, GAMMA, GAMMA)
  tol = GRAD_RTOL["float32"]
  np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                             atol=tol * np.abs(want).max())
  np.testing.assert_array_equal(ws.drn(*args, None, GAMMA, GAMMA).numpy(),
                                got.numpy())


def test_dwn_plain_matches_pallas_backward(reference):
  """The plain version of kernel D against ``_scores_bwd_pallas``'s d_wn
  (unit features in, before the l2-norm VJP)."""
  region, word, mask, g = _features(seed=7)
  rn = np.array(ws_pl.l2_normalize(jnp.asarray(region), axis=-1))
  wn = np.array(ws_pl.l2_normalize(jnp.asarray(word), axis=-1))
  _, want = ws_pl._scores_bwd_pallas(
      jnp.asarray(rn), jnp.asarray(wn), jnp.asarray(mask), jnp.asarray(g),
      GAMMA, GAMMA, interpret=True)
  want = np.asarray(want)
  args = [torch.from_numpy(x) for x in (rn, wn, mask, g)]
  got = ws.dwn_plain(*args, GAMMA, GAMMA)
  tol = GRAD_RTOL["float32"]
  np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                             atol=tol * np.abs(want).max())
  np.testing.assert_array_equal(ws.dwn(*args, None, GAMMA, GAMMA).numpy(),
                                got.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_word_scores_both_gradients_match_pallas(reference, dtype):
  """The public op differentiated with respect to regions and words at
  once, as ``tests/test_pallas.py`` differentiates the JAX op."""
  region, word, mask, g = _features(seed=8)
  jr, tr = _to_both(region, dtype)
  jw, tw = _to_both(word, dtype)
  jm, jg = jnp.asarray(mask), jnp.asarray(g)
  want = jax.grad(lambda r, w: jnp.sum(
      jg * ws_pl.word_scores(r, w, jm, GAMMA, GAMMA, True)),
                  argnums=(0, 1))(jr, jw)
  tr.requires_grad_()
  tw.requires_grad_()
  ws.word_scores(tr, tw, torch.from_numpy(mask), GAMMA, GAMMA).backward(
      torch.from_numpy(g))
  for got, w in zip((tr.grad, tw.grad), want):
    w = np.asarray(w, np.float32)
    np.testing.assert_allclose(got.float().numpy(), w, rtol=GRAD_RTOL[dtype],
                               atol=GRAD_RTOL[dtype] * np.abs(w).max())


def test_word_loss_pallas_path_matches_jax(reference):
  """`attention.word_loss(use_pallas=True)` (plain kernels on the CPU)
  against the JAX Pallas path."""
  region, word, mask, _ = _features(seed=6)
  max_len = (mask == 0).sum(axis=1, keepdims=True).astype(np.float32)
  with jax.disable_jit():
    want = jax_attention.word_loss(jnp.asarray(region), jnp.asarray(word),
                                   jnp.asarray(max_len), use_pallas=True)
  got = attention.word_loss(torch.from_numpy(region), torch.from_numpy(word),
                            torch.from_numpy(max_len), use_pallas=True)
  np.testing.assert_allclose([float(x) for x in got],
                             [float(x) for x in want], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version at the flagship shapes
# (56 examples, pooled width 1536, 256 regions, 17 words, 768 features).
# ---------------------------------------------------------------------------


def _flagship(device, seed=0):
  gen = torch.Generator(device=device).manual_seed(seed)
  region = torch.randn(56, 256, 768, device=device, generator=gen)
  word = torch.randn(56, 17, 768, device=device, generator=gen)
  max_len = torch.randint(3, 18, (56, 1), device=device, generator=gen)
  g = torch.randn(56, 56, device=device, generator=gen)
  return region, word, padding_mask(max_len, 17).contiguous(), g


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_ntxent_kernel(cuda, dtype):
  gen = torch.Generator(device=cuda).manual_seed(1)
  a = torch.randn(56, 1536, device=cuda, generator=gen).abs().to(dtype)
  b = torch.randn(56, 1536, device=cuda, generator=gen).to(dtype)
  before = ntxent.ntxent_stats.launches
  got = ntxent.ntxent_stats(a, b, 0.1)
  assert ntxent.ntxent_stats.launches == before + 1
  want = ntxent.ntxent_plain(a, b, 0.1)
  # f32 math from the same inputs on both sides: summation order only.
  torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_word_scores_kernel(cuda, dtype):
  region, word, mask, _ = _flagship(cuda)
  rn = l2_normalize(region.to(dtype).float()).contiguous()
  wn = l2_normalize(word).contiguous()
  got = ws.scores(rn, wn, mask, GAMMA, GAMMA)
  want = ws.scores_plain(rn, wn, mask, GAMMA, GAMMA)
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_word_scores_region_gradient(cuda, dtype):
  region, word, mask, g = _flagship(cuda, seed=2)
  region = region.to(dtype)
  x1 = region.clone().requires_grad_()
  ws.word_scores(x1, word, mask, GAMMA, GAMMA).backward(g)
  x2 = region.clone().requires_grad_()
  ws.scores_plain(l2_normalize(x2.float()), l2_normalize(word), mask, GAMMA,
                  GAMMA).t().backward(g)
  ref = x2.grad.float()
  rtol = 1e-4 if dtype == torch.float32 else 8e-3
  assert float((x1.grad.float() - ref).abs().max()) <= rtol * float(
      ref.abs().max())


@pytest.mark.gpu
def test_gpu_word_gradient_kernel(cuda):
  """Kernel D against its plain version, from the record kernel B saved."""
  region, word, mask, g = _flagship(cuda, seed=3)
  rn = l2_normalize(region).contiguous()
  wn = l2_normalize(word).contiguous()
  saved = ws.new_saved(rn, wn)
  ws.scores(rn, wn, mask, GAMMA, GAMMA, saved)
  before = ws.dwn.launches
  got = ws.dwn(rn, wn, mask, g, saved, GAMMA, GAMMA)
  assert ws.dwn.launches == before + 1
  want = ws.dwn_plain(rn, wn, mask, g, GAMMA, GAMMA)
  # f32 on both sides, TF32 off: summation order only.
  assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_word_scores_both_gradients(cuda, dtype):
  """The public op with both inputs asking for a gradient: kernels B, C
  and D against plain autograd."""
  region, word, mask, g = _flagship(cuda, seed=4)
  region, word = region.to(dtype), word.to(dtype)
  x1 = region.clone().requires_grad_()
  y1 = word.clone().requires_grad_()
  ws.word_scores(x1, y1, mask, GAMMA, GAMMA).backward(g)
  x2 = region.clone().requires_grad_()
  y2 = word.clone().requires_grad_()
  ws.scores_plain(l2_normalize(x2.float()), l2_normalize(y2.float()), mask,
                  GAMMA, GAMMA).t().backward(g)
  rtol = 1e-4 if dtype == torch.float32 else 8e-3
  for got, ref in ((x1.grad, x2.grad), (y1.grad, y2.grad)):
    ref = ref.float()
    assert float((got.float() - ref).abs().max()) <= rtol * float(
        ref.abs().max())

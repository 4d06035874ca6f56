"""The port's kernels (ops/cuda) against the JAX package's Pallas kernels.

CPU tests: the plain PyTorch version of each kernel (NT-Xent and its
gradient, word-score forward, word-score region and word gradients)
against the Pallas kernel run in interpret mode, at a small size with a
ragged mask, for float32 and for bfloat16 inputs, and the NT-Xent
backward kernel's formula (from the forward's record) modelled step by
step.  Inputs come from a numpy seed.

GPU tests (marker ``gpu``): each CUDA kernel against its plain version at
the flagship shapes, on random regions and on peaked ones (built from
their caption's words), and two calls of each word-score gradient bit for
bit.  They need a card and skip without one; on the card
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


def _ntxent_record(a, b, temperature):
  """What kernel ``ntxent_fwd`` records, in plain PyTorch: the logits, the
  inverse row norms of a and b, and the log-sum-exp of every row and every
  column of the logits."""
  a, b = a.float(), b.float()
  inv_a = torch.rsqrt(torch.clamp_min((a * a).sum(-1), 1e-12))
  inv_b = torch.rsqrt(torch.clamp_min((b * b).sum(-1), 1e-12))
  logits = (a @ b.t()) * inv_a[:, None] * inv_b[None, :] / temperature
  return (logits, inv_a, inv_b, torch.logsumexp(logits, 1),
          torch.logsumexp(logits, 0))


def _ntxent_record_backward(a, b, g, temperature):
  """Kernel ``ntxent_bwd``'s formula step by step from the record: dS from
  the logits and both log-sum-exps, and the radial coefficient T sum_j
  dS_ij S_ij in place of a D-long dot product a_n_i . d(a_n_i)."""
  logits, inv_a, inv_b, lse_row, lse_col = _ntxent_record(a, b, temperature)
  batch = logits.shape[0]
  eye = torch.eye(batch)
  ds = ((torch.exp(logits - lse_row[:, None])
         + torch.exp(logits - lse_col[None, :]) - 2 * eye)
        * g / (batch * temperature))
  an = a.float() * inv_a[:, None]
  bn = b.float() * inv_b[:, None]
  c_a = temperature * (ds * logits).sum(1)
  c_b = temperature * (ds * logits).sum(0)
  d_a = inv_a[:, None] * (ds @ bn - an * c_a[:, None])
  d_b = inv_b[:, None] * (ds.t() @ an - bn * c_b[:, None])
  return d_a.to(a.dtype), d_b.to(b.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ntxent_record_backward_matches_pallas(reference, dtype):
  """The backward kernel's decomposition against ``jax.grad`` of the
  Pallas op and against the plain backward (which the CPU wrapper runs).
  Tolerances: float32 math on all sides in other orders; with bf16 inputs
  the gradients are rounded to bf16, one bf16 ulp apart at most."""
  rng = np.random.default_rng(9)
  a = np.abs(rng.standard_normal((12, 40))).astype(np.float32)
  b = rng.standard_normal((12, 40)).astype(np.float32)
  ja, ta = _to_both(a, dtype)
  jb, tb = _to_both(b, dtype)
  want = jax.grad(
      lambda x, y: ntxent_pl.nt_xent_fused(x, y, 0.1, True)[0] * 3.0,
      argnums=(0, 1))(ja, jb)
  got = _ntxent_record_backward(ta, tb, 3.0, 0.1)
  plain = ntxent.ntxent_bwd_plain(ta, tb, torch.tensor(3.0), 0.1)
  wrapper = ntxent.ntxent_bwd(ta, tb, None, torch.tensor([3.0, 1.0, 1.0]),
                              0.1)
  for x, w, p, q in zip(got, want, plain, wrapper):
    w = np.asarray(w, np.float32)
    tol = GRAD_RTOL[dtype] * np.abs(w).max()
    np.testing.assert_allclose(x.float().numpy(), w, rtol=0, atol=tol)
    np.testing.assert_allclose(x.float().numpy(), p.float().numpy(), rtol=0,
                               atol=tol)
    assert q.dtype == x.dtype
    np.testing.assert_array_equal(q.float().numpy(), p.float().numpy())


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


def _flagship(device, seed=0, kind="random"):
  """Flagship inputs.  ``peaked``: each region is 3 x a real word of the
  image's own caption plus 0.5 x noise, which gives sharp alpha and |S|
  near 1, as trained features do."""
  gen = torch.Generator(device=device).manual_seed(seed)
  region = torch.randn(56, 256, 768, device=device, generator=gen)
  word = torch.randn(56, 17, 768, device=device, generator=gen)
  max_len = torch.randint(3, 18, (56, 1), device=device, generator=gen)
  g = torch.randn(56, 56, device=device, generator=gen)
  if kind == "peaked":
    pick = (torch.rand(56, 256, device=device, generator=gen)
            * max_len).long()
    region = (3 * torch.gather(word, 1, pick[..., None].expand(-1, -1, 768))
              + 0.5 * region)
  return region, word, padding_mask(max_len, 17).contiguous(), g


KINDS = ["random", "peaked"]


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
def test_gpu_ntxent_backward_kernel(cuda, dtype):
  """Kernel ``ntxent_bwd`` from the forward's record against the plain
  backward, and the fused op's autograd through it."""
  gen = torch.Generator(device=cuda).manual_seed(6)
  a = torch.randn(56, 1536, device=cuda, generator=gen).abs().to(dtype)
  b = torch.randn(56, 1536, device=cuda, generator=gen).to(dtype)
  record = torch.empty(ntxent.record_floats(56), device=cuda)
  ntxent.ntxent_stats(a, b, 0.1, record)
  g_out = torch.tensor([1.7, 0.3, 0.2], device=cuda)
  before = ntxent.ntxent_bwd.launches
  got = ntxent.ntxent_bwd(a, b, record, g_out, 0.1)
  assert ntxent.ntxent_bwd.launches == before + 1
  want = ntxent.ntxent_bwd_plain(a, b, g_out[0], 0.1)
  # f32: summation order only.  bf16: one bf16 ulp (2^-8 relative).
  rtol = 1e-4 if dtype == torch.float32 else 8e-3
  for x, y in zip(got, want):
    assert x.dtype == dtype
    assert float((x.float() - y.float()).abs().max()) <= rtol * float(
        y.float().abs().max())
  x = a.clone().requires_grad_()
  y = b.clone().requires_grad_()
  loss, _, _ = ntxent.nt_xent_fused(x, y, 0.1)
  (1.7 * loss).backward()
  assert ntxent.ntxent_bwd.launches == before + 2
  assert torch.equal(x.grad, got[0]) and torch.equal(y.grad, got[1])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_word_scores_kernel(cuda, dtype, kind):
  region, word, mask, _ = _flagship(cuda, kind=kind)
  rn = l2_normalize(region.to(dtype).float()).contiguous()
  wn = l2_normalize(word).contiguous()
  got = ws.scores(rn, wn, mask, GAMMA, GAMMA)
  want = ws.scores_plain(rn, wn, mask, GAMMA, GAMMA)
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_word_scores_region_gradient(cuda, dtype, kind):
  region, word, mask, g = _flagship(cuda, seed=2, kind=kind)
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
@pytest.mark.parametrize("kind", KINDS)
def test_gpu_region_gradient_kernel(cuda, kind):
  """Kernel C against its plain version from the record kernel B saved,
  and two calls on the same inputs bit for bit (every output tile is
  summed by one block in a fixed order)."""
  region, word, mask, g = _flagship(cuda, seed=5, kind=kind)
  rn = l2_normalize(region).contiguous()
  wn = l2_normalize(word).contiguous()
  saved = ws.new_saved(rn, wn)
  ws.scores(rn, wn, mask, GAMMA, GAMMA, saved)
  before = ws.drn.launches
  got = ws.drn(rn, wn, mask, g, saved, GAMMA, GAMMA)
  again = ws.drn(rn, wn, mask, g, saved, GAMMA, GAMMA)
  assert ws.drn.launches == before + 2
  assert torch.equal(got, again)
  want = ws.drn_plain(rn, wn, mask, g, GAMMA, GAMMA)
  # float32 accuracy on both sides (3xTF32 on the card), TF32 off in the
  # plain version: summation order only.
  assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_gpu_word_gradient_kernel(cuda, kind):
  """Kernel D against its plain version, from the record kernel B saved,
  and two calls on the same inputs bit for bit (the parts of the depth are
  added in a fixed order)."""
  region, word, mask, g = _flagship(cuda, seed=3, kind=kind)
  rn = l2_normalize(region).contiguous()
  wn = l2_normalize(word).contiguous()
  saved = ws.new_saved(rn, wn)
  ws.scores(rn, wn, mask, GAMMA, GAMMA, saved)
  before = ws.dwn.launches
  got = ws.dwn(rn, wn, mask, g, saved, GAMMA, GAMMA)
  again = ws.dwn(rn, wn, mask, g, saved, GAMMA, GAMMA)
  assert ws.dwn.launches == before + 2
  assert torch.equal(got, again)
  want = ws.dwn_plain(rn, wn, mask, g, GAMMA, GAMMA)
  # float32 accuracy on both sides (3xTF32 on the card), TF32 off in the
  # plain version: summation order only.
  assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_word_scores_both_gradients(cuda, dtype, kind):
  """The public op with both inputs asking for a gradient: kernels B, C
  and D against plain autograd."""
  region, word, mask, g = _flagship(cuda, seed=4, kind=kind)
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


# ---------------------------------------------------------------------------
# The modulated-norm kernels (csrc/modulated_norm.cu).
# ---------------------------------------------------------------------------

# (rows, channels, side, factor or None for dense terms alone) of every
# norm of G: 128 px at 56 rows (GenBlock_0/1's ConditionalBatchNorms, the
# spatial blocks' and the final FusedSpatialModulations at factors 1-8),
# 256 px at the microbatch of 128 (factors 1-16).
NORM_SHAPES = [
    (56, 1536, 4, None), (56, 1536, 8, None), (56, 768, 16, None),
    (56, 768, 16, 1), (56, 384, 32, 2), (56, 192, 64, 4), (56, 96, 128, 8),
    (128, 1536, 4, None), (128, 1536, 8, None), (128, 768, 16, None),
    (128, 768, 16, 1), (128, 768, 32, 2), (128, 384, 64, 4),
    (128, 192, 128, 8), (128, 96, 256, 16),
]


def _norm_inputs(device, shape, dtype=torch.bfloat16, seed=0,
                 constant=True):
  """x and (gamma_local, gamma_dense, beta_local, beta_dense) as G's
  layers give them: x with channels of different means and scales and,
  with ``constant``, one constant channel (its variance at or near 0,
  where y amplifies the sums' last bits 316-fold)."""
  n, c, side, factor = shape
  gen = torch.Generator(device=device).manual_seed(seed)

  def normal(*s, scale=1.0):
    return scale * torch.randn(*s, device=device, generator=gen)

  x = (normal(n, c, side, side) * (0.5 + normal(c).abs())[:, None, None]
       + normal(c)[:, None, None])
  if constant:
    x[:, 0] = 0.37
  local = None if factor is None else (n, c, side // factor, side // factor)
  terms = [None if local is None else normal(*local, scale=0.3),
           normal(n, c, scale=0.3),
           None if local is None else normal(*local, scale=0.3),
           normal(n, c, scale=0.3)]
  return x.to(dtype), [t if t is None else t.to(dtype) for t in terms]


def _tickets(device):
  """The modulated-norm kernels' tickets for the current stream."""
  from xmcgan_image_generation_tpu_torch.ops.cuda import modulated_norm as mn

  return mn._tickets(device, torch.cuda.current_stream(device).cuda_stream)


def _unfused(x, terms, factor, relu):
  """The modules' own operations: BatchNorm, then the modulation."""
  from xmcgan_image_generation_tpu_torch.ops import normalization
  from xmcgan_image_generation_tpu_torch.ops.cuda import modulated_norm as mn

  bn = normalization.BatchNorm(x.shape[1], dtype=x.dtype, device=x.device)
  gl, gd, bl, bd = terms
  out = (bn(x) * (mn.modulation(gl, gd, factor) + 1.0)
         + mn.modulation(bl, bd, factor))
  return torch.relu(out) if relu else out


@pytest.mark.gpu
@pytest.mark.parametrize("shape", NORM_SHAPES, ids=str)
def test_gpu_modnorm_forward_is_the_unfused_path(cuda, shape):
  """Given the plain statistics, the output is the unfused bf16 path's bit
  for bit (and the statistics BatchNorm's); the kernel's sums agree with
  the plain ones to float32 summation order; two launches agree bit for
  bit; the counters advance."""
  from xmcgan_image_generation_tpu_torch.ops.cuda import modulated_norm as mn

  factor = shape[3] or 1
  x, terms = _norm_inputs(cuda, shape)
  count = x.numel() // x.shape[1]
  want_sums = mn.stats_plain(x)
  # Each shape's first launch allocates the tickets anew, as a process's
  # first launch does.
  mn._tickets.cache_clear()
  before = (mn.norm_stats.launches, mn.norm_apply.launches)
  sums = mn.norm_stats(x)
  assert torch.equal(sums, mn.norm_stats(x))
  # f32 sums of up to 8.4 M bf16 values in other orders.
  bound = 1e-5 * torch.stack([x.float().abs().sum((0, 2, 3)),
                              x.float().square().sum((0, 2, 3))])
  assert bool(((sums - want_sums).abs() <= bound + 1e-6).all())
  for relu in (True, False):
    out, mean, var = mn.norm_apply(x, want_sums, count, *terms, factor, relu)
    again = mn.norm_apply(x, want_sums, count, *terms, factor, relu)[0]
    assert torch.equal(out, again)
    assert torch.equal(out, _unfused(x, terms, factor, relu))
    want_mean, want_var, _, _ = mn._finalize(want_sums, count, 1e-5)
    assert torch.equal(mean, want_mean) and torch.equal(var, want_var)
  assert (mn.norm_stats.launches, mn.norm_apply.launches) == (
      before[0] + 2, before[1] + 4)
  assert int(_tickets(cuda).count_nonzero()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", NORM_SHAPES, ids=str)
def test_gpu_modnorm_backward_kernels(cuda, shape):
  """Each backward output against the plain stage on the same inputs:
  the channel sums to float32 order, the terms' gradients (rounded to
  bf16 once, against the plain stage's sums of bf16 products) and dx
  within bf16 rounding; two launches bit for bit."""
  from xmcgan_image_generation_tpu_torch.ops.cuda import modulated_norm as mn

  factor = shape[3] or 1
  x, terms = _norm_inputs(cuda, shape, seed=1)
  dout = torch.randn(x.shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(2)
                     ).to(x.dtype)
  count = x.numel() // x.shape[1]
  sums = mn.stats_plain(x)
  mn._tickets.cache_clear()
  before = (mn.norm_bwd_reduce.launches, mn.norm_bwd_dx.launches)
  got = mn.norm_bwd_reduce(x, dout, sums, count, *terms, factor, True)
  again = mn.norm_bwd_reduce(x, dout, sums, count, *terms, factor, True)
  want = mn.bwd_reduce_plain(x, dout, sums, count, *terms, factor, True)
  for g, a in zip(got, again):
    assert g is None or torch.equal(g, a)
  # The channel sums: f32 sums of up to 8.4 M products in other orders.
  scale = float(want[0].abs().max())
  assert float((got[0] - want[0]).abs().max()) <= 1e-4 * scale
  for g, w in zip(got[1:], want[1:]):
    if w is not None:
      # One bf16 rounding of sums the two sides take in other orders.
      torch.testing.assert_close(g.float(), w.float(), rtol=1e-2,
                                 atol=1e-2 * float(w.float().abs().max()))
  dx = mn.norm_bwd_dx(x, dout, sums, got[0], count, *terms, factor, True)
  assert torch.equal(dx, mn.norm_bwd_dx(x, dout, sums, got[0], count,
                                        *terms, factor, True))
  want_dx = mn.bwd_dx_plain(x, dout, sums, got[0], count, *terms, factor,
                            True)
  torch.testing.assert_close(dx.float(), want_dx.float(), rtol=1e-2,
                             atol=1e-2 * float(want_dx.float().abs().max()))
  assert (mn.norm_bwd_reduce.launches, mn.norm_bwd_dx.launches) == (
      before[0] + 2, before[1] + 2)
  assert int(_tickets(cuda).count_nonzero()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_modnorm_function_against_autograd(cuda, dtype):
  """The autograd function on the card against autograd through the
  unfused modules, at 128 px's last norm (factor 8) and a 4 x 4 plane of
  dense terms alone: the output, statistics and every gradient.  Without
  the ReLU: the two sides take their sums in other orders, which moves
  the few outputs next to 0 across it and so the mask (the ReLU's
  gradient is held to the plain stage on the same sums above)."""
  from xmcgan_image_generation_tpu_torch.ops.cuda import modulated_norm as mn

  for seed, shape in enumerate([(56, 96, 128, 8), (56, 1536, 4, None)]):
    factor = shape[3] or 1
    x, terms = _norm_inputs(cuda, shape, dtype, seed=seed, constant=False)
    ct = torch.randn(x.shape, device=cuda, dtype=dtype)
    leaves = [[t if t is None else t.clone().requires_grad_()
               for t in [x] + terms] for _ in range(2)]
    got, mean, var = mn.modulated_batch_norm(*leaves[0], factor, False)
    (got.float() * ct.float()).sum().backward()
    want = _unfused(leaves[1][0], leaves[1][1:], factor, False)
    (want.float() * ct.float()).sum().backward()
    # float32: the sums' order, amplified up to |mean| / std-fold where x
    # meets its mean; bf16: a rounding of the output and of dy.
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * float(want.detach().abs().max()))
    torch.testing.assert_close(mean, x.float().mean((0, 2, 3)), rtol=1e-4,
                               atol=1e-5)
    for g, w in zip(leaves[0], leaves[1]):
      if w is not None:
        w = w.grad.float()
        torch.testing.assert_close(g.grad.float(), w, rtol=tol * 4,
                                   atol=tol * 4 * float(w.abs().max()))


@pytest.mark.gpu
def test_gpu_modnorm_streams_have_their_own_tickets(cuda):
  """Launches on a side stream use tickets of their own, so two streams
  never share a channel's counter, and give the default stream's sums."""
  from xmcgan_image_generation_tpu_torch.ops.cuda import modulated_norm as mn

  x, terms = _norm_inputs(cuda, NORM_SHAPES[6])
  want = mn.norm_stats(x)
  side = torch.cuda.Stream(cuda)
  side.wait_stream(torch.cuda.current_stream(cuda))
  with torch.cuda.stream(side):
    got = mn.norm_stats(x)
    side_tickets = _tickets(cuda)
  torch.cuda.current_stream(cuda).wait_stream(side)
  assert side_tickets.data_ptr() != _tickets(cuda).data_ptr()
  assert torch.equal(got, want)
  assert int(side_tickets.count_nonzero()) == 0

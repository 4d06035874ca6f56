"""G's modulated BatchNorms as one function (`ops.cuda.modulated_norm`)
against the unfused modules, on the CPU in float32.

`modulated_batch_norm` runs its plain stages for CPU tensors, the same
stages the kernels of ``csrc/modulated_norm.cu`` compute on the card.
Each case holds it to autograd through today's modules: the output, the
batch statistics, the running averages, and the gradients of x and of
each local and dense term (the function called with them as leaves), then
the module's output, running averages and every gradient with the
modules sent through the function (`normalization.takes_kernels`, which
picks it only for CUDA tensors, made to pick it here).  Cases: the three
modulated norms, `FusedSpatialModulation` at factors 1, 2, 8 and 16, ReLU
on and off, 4x4 planes, a constant channel (whose variance is clamped at
0), the critic's no-grad forward under `frozen_state`,
`frozen_batch_stats` with gradients, and a rematerialized
`GenSpatialBlockFused` against one without remat.  float32 on both sides,
the statistics reduced in float32 as `BatchNorm` reduces them: the
output is computed in the same order, the gradients by other formulas
(the closed form against autograd's chain), so that they agree to
float32 rounding.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu_torch.models import blocks
from xmcgan_image_generation_tpu_torch.models import xmc_net
from xmcgan_image_generation_tpu_torch.ops import normalization
from xmcgan_image_generation_tpu_torch.ops.cuda import modulated_norm as mn

torch.set_num_threads(1)

F32 = torch.float32
BATCH, CHANNELS, CTX, GLOBAL = 4, 6, 5, 7
# A constant channel of this value has a variance below 0 in float32 at
# 4 x 8 x 8, which the clamp sets to 0 (and stops its gradient).
CLAMPED = 0.41


def _close(got, want, what):
  # float32 sums of a few hundred terms in other orders.  The absolute
  # floor covers gradients that are 0 but for rounding (a conv's bias
  # before a BatchNorm, 3.8e-6 here).
  scale = max(float(want.detach().abs().max()), 1.0)
  np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                             rtol=1e-5, atol=1e-5 * scale, err_msg=what)


def _normal(rng, *shape, scale=1.0, shift=0.0):
  return torch.from_numpy(scale * rng.standard_normal(shape) + shift).to(F32)


def _fused(monkeypatch):
  """The modules take `modulated_batch_norm` on the CPU too."""
  monkeypatch.setattr(
      normalization, "takes_kernels",
      lambda norm, x: norm.training and type(norm) is normalization.BatchNorm)


# (kind, factor, relu, side)
CASES = {
    "conditional": ("cbn", 1, True, 8),
    "conditional_no_relu": ("cbn", 1, False, 8),
    "conditional_4x4": ("cbn", 1, True, 4),
    "fused_f1": ("fsm", 1, True, 16),
    "fused_f2": ("fsm", 2, True, 16),
    "fused_f2_no_relu": ("fsm", 2, False, 16),
    "fused_f8": ("fsm", 8, True, 16),
    "fused_f16": ("fsm", 16, True, 16),
    "local": ("lcbn", 1, True, 8),
    "constant_channel": ("fsm", 2, True, 8),
    "critic_no_grad": ("fsm", 2, True, 8),
    "frozen_batch_stats": ("cbn", 1, True, 8),
    "remat": ("block", 2, True, 8),
}


def _terms(rng, kind, factor, side):
  """The function's (gamma_local, gamma_dense, beta_local, beta_dense)."""
  local = (BATCH, CHANNELS, side // factor, side // factor)
  has_local, has_dense = kind in ("fsm", "lcbn"), kind in ("fsm", "cbn")
  return [(_normal(rng, *local, scale=0.5) if has_local else None),
          (_normal(rng, BATCH, CHANNELS, scale=0.5) if has_dense else None),
          (_normal(rng, *local, scale=0.5) if has_local else None),
          (_normal(rng, BATCH, CHANNELS, scale=0.5) if has_dense else None)]


def _check_function(rng, name, kind, factor, relu, side):
  """`modulated_batch_norm` against `BatchNorm` and the modulation."""
  x = _normal(rng, BATCH, CHANNELS, side, side, shift=0.3)
  if name == "constant_channel":
    x[:, 1] = CLAMPED
  terms = _terms(rng, kind, factor, side)
  ct = _normal(rng, *x.shape)

  def leaves():
    return [t if t is None else t.clone().requires_grad_()
            for t in [x] + terms]

  ref_in = leaves()
  bn = normalization.BatchNorm(CHANNELS, dtype=F32)
  gl, gd, bl, bd = ref_in[1:]
  want = (bn(ref_in[0]) * (mn.modulation(gl, gd, factor) + 1.0)
          + mn.modulation(bl, bd, factor))
  if relu:
    want = torch.relu(want)
  (want * ct).sum().backward()

  got_in = leaves()
  got, mean, var = mn.modulated_batch_norm(*got_in, factor, relu)
  (got * ct).sum().backward()
  assert not (mean.requires_grad or var.requires_grad)
  _close(got, want, "out")
  _close(mean, x.mean(dim=(0, 2, 3)), "mean")
  _close(var, x.var(dim=(0, 2, 3), unbiased=False), "var")
  # BatchNorm's running averages (float32) from the same statistics.
  for stat, init, running in ((mean, 0.0, bn.mean), (var, 1.0, bn.var)):
    np.testing.assert_allclose(running.numpy(),
                               (0.9 * init + 0.1 * stat).float().numpy(),
                               rtol=1e-6)
  if name == "constant_channel":
    assert var[1] == 0 and mn._finalize(mn.stats_plain(x), x.numel() //
                                        CHANNELS, 1e-5)[1][1] == 0
  for label, g, w in zip(("x", "gamma_local", "gamma_dense", "beta_local",
                          "beta_dense"), got_in, ref_in):
    if w is not None:
      _close(g.grad, w.grad, f"d {label}")


def _module(kind, factor, gen):
  kw = dict(dtype=F32, generator=gen)
  if kind == "cbn":
    return normalization.ConditionalBatchNorm(CHANNELS, GLOBAL, **kw)
  if kind == "lcbn":
    return normalization.LocalConditionalBatchNorm(CHANNELS, CTX, **kw)
  if kind == "fsm":
    return normalization.FusedSpatialModulation(CHANNELS, CTX, GLOBAL,
                                                factor, **kw)
  block = blocks.GenSpatialBlockFused(CHANNELS, 4, CTX, GLOBAL, factor,
                                      scale_fuse=False, **kw)
  block.remat_policy = None
  return block


def _module_inputs(rng, kind, factor, side):
  x = _normal(rng, BATCH, CHANNELS, side, side, shift=0.3)
  ctx = _normal(rng, BATCH, CTX, side // factor, side // factor)
  glob = _normal(rng, BATCH, GLOBAL)
  if kind == "cbn":
    return [x, glob]
  if kind == "lcbn":
    return [x, ctx]
  return [x, ctx, glob]


def _run_module(module, kind, inputs, relu):
  if kind == "block":
    return xmc_net._run_block(module, *inputs)
  return module(*inputs, relu=relu)


def _check_module(rng, name, kind, factor, relu, side, monkeypatch):
  """The module through the function against the module unfused."""
  gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
  ref = _module(kind, factor, gen)
  inputs = _module_inputs(rng, kind, factor, side)
  if name == "constant_channel":
    inputs[0][:, 1] = CLAMPED
  mod = copy.deepcopy(ref)
  state0 = copy.deepcopy(ref.state_dict())
  if name == "critic_no_grad":
    with torch.no_grad(), normalization.frozen_state(ref):
      want = _run_module(ref, kind, inputs, relu)
    _fused(monkeypatch)
    with torch.no_grad(), normalization.frozen_state(mod):
      got = _run_module(mod, kind, inputs, relu)
    _close(got, want, "critic's out")
    for key, value in mod.state_dict().items():
      assert torch.equal(value, state0[key]), key
    return
  ref_in = [t.clone().requires_grad_() for t in inputs]
  got_in = [t.clone().requires_grad_() for t in inputs]
  frozen = (normalization.frozen_batch_stats if name == "frozen_batch_stats"
            else lambda m: contextlib.nullcontext())
  with frozen(ref):
    want = _run_module(ref, kind, ref_in, relu)
  ct = _normal(rng, *want.shape)
  (want * ct).sum().backward()
  _fused(monkeypatch)
  if name == "remat":
    mod.remat_policy = "full"
  with frozen(mod):
    got = _run_module(mod, kind, got_in, relu)
  (got * ct).sum().backward()
  _close(got, want, "module out")
  for (key, g), w in zip(mod.state_dict().items(),
                         ref.state_dict().values()):
    _close(g, w, key)
    if name == "frozen_batch_stats":
      assert torch.equal(g, state0[key]), key
  for i, (g, w) in enumerate(zip(got_in, ref_in)):
    _close(g.grad, w.grad, f"d input {i}")
  for (key, g), w in zip(mod.named_parameters(), ref.parameters()):
    _close(g.grad, w.grad, f"d {key}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_unfused_modules(name, monkeypatch):
  kind, factor, relu, side = CASES[name]
  rng = np.random.default_rng(sorted(CASES).index(name))
  if kind != "block":
    _check_function(rng, name, kind, factor, relu, side)
  _check_module(rng, name, kind, factor, relu, side, monkeypatch)

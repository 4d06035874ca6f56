"""The port's bfloat16 path against the JAX package's, on the CPU.

The flagship computes in bfloat16 the way flax does: parameters stay
float32, each layer casts its input and its (normalized) kernel to
bfloat16 and returns bfloat16, BatchNorm statistics are taken in float32,
and the contrastive heads upcast their features to float32.  Here the
same bfloat16 inputs and bridged weights go through each layer of the
flagship path in both frameworks, then through G as a whole.

Tolerance.  Both sides round the same float32 results to bfloat16 at the
same places; only float32 summation orders differ, so an output rounds
the other way only where the exact value lies within float32 noise of a
rounding boundary.  Each layer's output must be the JAX output's own
bfloat16 value in at least 99 % of elements, and within one bfloat16 ulp
everywhere.  A cast placed elsewhere (an op done in float32 that JAX
rounds to bfloat16 first, or the reverse) moves a large share of the
elements by an ulp and fails the first rule.  Float32 state the layers
update (running statistics, ``u0``) holds to 1e-5 relative.

G as a whole, in eval mode: the rare flips of each layer feed the next
ones, so the rules become 95 % and two ulps.  (In train mode the batch
statistics spread every flip over a whole channel; that is no longer a
comparison of cast placement, so the layers carry that check.)

D as a whole, in train and eval mode (D has no BatchNorm): as for G,
its logits within two ulps, but only 8 of them, so half must be equal;
its statistics, float32 reductions of bfloat16 features, within 2e-3
relative (half a bfloat16 ulp), each accuracy within one flipped near-tie
(1 / (2 B)), and ``u0``, a float32 power iteration, to 1e-5.

One critic update in bfloat16: D's gradient of every kernel within 5e-2
relative in the l2 norm.  Each backward layer rounds its cotangent to
bfloat16 (2^-9 relative), and the rounding differences of a dozen layers
add up to about 2e-2.  Bias gradients are left out: a bias gradient sums
a bfloat16 cotangent over batch and space (8192 terms in D's first conv),
which XLA:CPU accumulates in bfloat16, so the sum stalls (8192 ones sum to
256), while PyTorch accumulates in float32.  The float32 step test holds
them.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.engine import create_train_state as j_state
from xmcgan_image_generation_tpu.engine import xmc_gan as j_xmc_gan
from xmcgan_image_generation_tpu.engine.step import split_batch as j_split
from xmcgan_image_generation_tpu.models import get_architecture as j_arch
from xmcgan_image_generation_tpu.models import xmc_net as j_xmc_net
from xmcgan_image_generation_tpu.ops import attention as j_attention
from xmcgan_image_generation_tpu.ops import contrastive as j_contrastive
from xmcgan_image_generation_tpu.ops import normalization as j_norm
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.data import synthetic
from xmcgan_image_generation_tpu_torch.engine import xmc_gan
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.engine.step import split_batch
from xmcgan_image_generation_tpu_torch.models import xmc_net
from xmcgan_image_generation_tpu_torch.ops import attention
from xmcgan_image_generation_tpu_torch.ops import contrastive
from xmcgan_image_generation_tpu_torch.ops import normalization
from xmcgan_image_generation_tpu_torch.ops import spectral_norm
from xmcgan_image_generation_tpu_torch.utils import bridge

torch.set_num_threads(1)

MUTABLE = ["batch_stats", "spectral_norm_stats"]


def bf16(shape, seed, scale=1.0):
  """A bfloat16 JAX array and the same values as a bfloat16 tensor."""
  x = np.random.default_rng(seed).standard_normal(shape) * scale
  j = jnp.asarray(x, jnp.bfloat16)
  return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
  """|got - want| in bfloat16 ulps (8 significant bits) at the larger
  magnitude of the two."""
  mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
  return np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)


def assert_bf16_close(got: torch.Tensor, want, min_equal=0.99, max_ulps=1):
  assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
  got = got.detach().float().numpy()
  want = np.asarray(want.astype(jnp.float32))
  assert got.shape == want.shape
  equal = float(np.mean(got == want))
  worst = float(ulps(got, want).max())
  assert equal >= min_equal and worst <= max_ulps, (
      f"{equal:.4f} of elements equal (need {min_equal}), worst "
      f"{worst:.1f} ulps (allowed {max_ulps})")


def assert_state_close(module: torch.nn.Module, new_vars) -> None:
  got = bridge.flatten(bridge.jax_from_state_dict(module.state_dict()))
  want = bridge.flatten(jax.device_get(
      {k: v for k, v in new_vars.items() if k in MUTABLE}))
  assert want, "the layer updated no state"
  for name, value in want.items():
    np.testing.assert_allclose(got[name], np.asarray(value), rtol=1e-5,
                               atol=1e-7, err_msg=name)


def nchw(x: torch.Tensor) -> torch.Tensor:
  return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
  return x.permute(0, 2, 3, 1)


def _factories(spectral: bool, train: bool):
  return j_xmc_net._layer_factories(spectral, train, jnp.bfloat16,
                                    up_method="dilated")


def _norm_fn(train: bool):
  return functools.partial(fnn.BatchNorm, use_running_average=not train,
                           momentum=0.9, epsilon=1e-5, dtype=jnp.bfloat16)


def _random_biases(tree, rng):
  """Non-zero biases (flax starts them at zero), so that where a bias is
  added and rounded shows in the output."""
  return {k: (_random_biases(v, rng) if isinstance(v, dict) else
              rng.standard_normal(v.shape).astype(np.float32) if k == "bias"
              else v)
          for k, v in tree.items()}


def _run(j_module, j_args, port, port_args, train, stats=None):
  """Both sides on the JAX initialization, with random biases; returns
  (got, want, new)."""
  variables = jax.device_get(j_module.init(jax.random.PRNGKey(0), *j_args))
  if "params" in variables:
    variables["params"] = _random_biases(variables["params"],
                                         np.random.default_rng(4))
  if stats is not None:
    variables["batch_stats"] = stats(variables.get("batch_stats", {}))
  want, new = j_module.apply(variables, *j_args, mutable=MUTABLE)
  bridge.load_jax_variables(port, variables)
  port.train(train)
  return port(*port_args), want, new


def _running_stats(tree):
  """Non-trivial running averages, so that eval mode is exercised."""
  rng = np.random.default_rng(3)
  return jax.tree_util.tree_map(
      lambda v: (v + rng.uniform(0.1, 0.5, v.shape)).astype(np.float32),
      tree)


BF = torch.bfloat16


@pytest.mark.parametrize("scale_op", ["none", "pool"])
def test_spectral_conv(scale_op):
  """D's 3x3 convs, spectrally normalized, in train mode (``u0`` moves)."""
  jx, tx = bf16((4, 8, 8, 6), 0)
  conv_fn, _ = _factories(spectral=True, train=True)
  port = spectral_norm.Conv(6, 5, (3, 3), spectral=True, scale_op=scale_op,
                            dtype=BF)
  got, want, new = _run(conv_fn(5, kernel_size=(3, 3), scale_op=scale_op),
                        (jx,), port, (nchw(tx),), True)
  assert_bf16_close(nhwc(got), want)
  assert_state_close(port, new)


def test_upsample_conv():
  """G's scale-fused up-conv (dilated), a plain conv."""
  jx, tx = bf16((4, 4, 4, 6), 1)
  conv_fn, _ = _factories(spectral=False, train=True)
  port = spectral_norm.Conv(6, 5, (3, 3), scale_op="up", dtype=BF)
  got, want, _ = _run(conv_fn(5, kernel_size=(3, 3), scale_op="up"), (jx,),
                      port, (nchw(tx),), True)
  assert_bf16_close(nhwc(got), want)


@pytest.mark.parametrize("spectral", [True, False])
def test_dense(spectral):
  jx, tx = bf16((4, 24), 2)
  _, dense_fn = _factories(spectral=spectral, train=True)
  port = spectral_norm.Dense(24, 7, spectral=spectral, dtype=BF)
  got, want, new = _run(dense_fn(7), (jx,), port, (tx,), True)
  assert_bf16_close(got, want)
  if spectral:
    assert_state_close(port, new)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm(train):
  """Statistics in float32 from bfloat16 inputs, bfloat16 out."""
  jx, tx = bf16((4, 5, 5, 6), 3, scale=3.0)
  port = normalization.BatchNorm(6, dtype=BF)
  got, want, new = _run(
      _norm_fn(train)(use_bias=False, use_scale=False), (jx,), port,
      (nchw(tx),), train, stats=_running_stats)
  assert_bf16_close(nhwc(got), want)
  if train:
    assert_state_close(port, new)


def test_conditional_batch_norm():
  """G's GenBlock normalization: BN, then ``x (gamma + 1) + beta``."""
  jx, tx = bf16((4, 4, 4, 6), 4, scale=2.0)
  jemb, temb = bf16((4, 10), 5)
  _, dense_fn = _factories(spectral=False, train=True)
  port = normalization.ConditionalBatchNorm(6, 10, dtype=BF)
  got, want, new = _run(
      j_norm.ConditionalBatchNorm(norm_fn=_norm_fn(True), dense_fn=dense_fn),
      (jx, jemb), port, (nchw(tx), temb), True)
  assert_bf16_close(nhwc(got), want)
  assert_state_close(port, new)


def test_fused_spatial_modulation():
  """G's spatial blocks: BN modulated by the upsampled region context."""
  jx, tx = bf16((4, 8, 8, 6), 6, scale=2.0)
  jctx, tctx = bf16((4, 4, 4, 12), 7, scale=0.3)
  jglob, tglob = bf16((4, 10), 8)
  conv_fn, dense_fn = _factories(spectral=False, train=True)
  port = normalization.FusedSpatialModulation(6, 12, 10, factor=2, dtype=BF)
  got, want, new = _run(
      j_norm.FusedSpatialModulation(norm_fn=_norm_fn(True), conv_fn=conv_fn,
                                    dense_fn=dense_fn, factor=2),
      (jx, jctx, jglob), port, (nchw(tx), nchw(tctx), tglob), True)
  assert_bf16_close(nhwc(got), want)
  assert_state_close(port, new)


def test_attention_for_g():
  """G's word-region attention takes bfloat16 regions into float32."""
  jr, tr = bf16((2, 16, 12), 9)
  jw, tw = bf16((2, 5, 12), 10)
  max_len = np.array([[3.0], [5.0]], np.float32)
  mask = j_attention.padding_mask(max_len, 5)
  want, _ = j_attention.attention_for_g(jr, jw, 15.0, mask)
  got, _ = attention.attention_for_g(tr, tw, 15.0,
                                     torch.from_numpy(np.array(mask)))
  assert got.dtype == torch.float32 and want.dtype == jnp.float32
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_contrastive_heads(use_pallas):
  """D's heads on bfloat16 features reduce in float32 on both sides."""
  jr, tr = bf16((4, 16, 12), 11)
  jw, tw = bf16((4, 5, 12), 12)
  ja, ta = bf16((4, 24), 13)
  jb, tb = bf16((4, 24), 14)
  max_len = np.array([[3.0], [5.0], [4.0], [2.0]], np.float32)
  want = (j_attention.word_loss(jr, jw, max_len)
          + j_contrastive.nt_xent(ja, jb))
  got = (attention.word_loss(tr, tw, torch.from_numpy(max_len),
                             use_pallas=use_pallas)
         + contrastive.nt_xent(ta, tb, use_pallas=use_pallas))
  for g, w in zip(got, want):
    assert g.dtype == torch.float32 and w.dtype == jnp.float32
  np.testing.assert_allclose(torch.stack(got).numpy(), np.array(want),
                             rtol=1e-5, atol=1e-5)


def _configs():
  """The test config (32 px, width 16) in bfloat16, both frameworks."""
  j_config = j_coco_xmc.get_test_config()
  config = coco_xmc.get_test_config()
  for c in (j_config, config):
    c.dtype, c.scale_fused_convs, c.upconv_method = (
        "bfloat16", True, "dilated")
  return j_config, config


def _flat(tree):
  return {k: np.asarray(v, np.float32)
          for k, v in bridge.flatten(jax.device_get(tree)).items()}


def test_generator_eval():
  """G as a whole at the test config (32 px, width 16) in bfloat16."""
  j_config, config = _configs()
  rng = np.random.default_rng(0)
  batch = {
      "embedding": rng.standard_normal((4, 17, 768)).astype(np.float32),
      "sentence_embedding": rng.standard_normal((4, 768)).astype(np.float32),
      "max_len": rng.integers(3, 18, (4, 1)).astype(np.float32),
  }
  z = rng.standard_normal((4, config.z_dim)).astype(np.float32)
  gen, _ = j_arch(j_config, jnp.bfloat16)
  variables = jax.device_get(gen(train=False).init(jax.random.PRNGKey(1),
                                                   (batch, z)))
  variables["batch_stats"] = _running_stats(variables["batch_stats"])
  want = gen(train=False).apply(variables, (batch, z))
  g = xmc_net.Generator(config, generator=torch.Generator().manual_seed(0))
  bridge.load_jax_variables(g, variables)
  g.eval()
  with torch.no_grad():
    got = g({k: torch.from_numpy(v) for k, v in batch.items()},
            torch.from_numpy(z))
  assert got.shape == (4, 32, 32, 3)
  assert_bf16_close(got, want, min_equal=0.95, max_ulps=2)


@pytest.fixture(scope="module")
def disc_inputs():
  """D's JAX initialization at the test config, and its inputs."""
  j_config, config = _configs()
  batch = synthetic.super_batch(config, np.random.default_rng(0))
  assert len(batch["image"]) == 4
  # Real images, then the same images reversed in the place of fakes.
  images = batch.pop("image").astype(np.float32) / 127.5 - 1.0
  images = np.concatenate([images, images[::-1]])
  _, disc = j_arch(j_config, jnp.bfloat16)
  variables = jax.device_get(disc(train=False).init(jax.random.PRNGKey(2),
                                                    (images, batch)))
  return dict(config=config, disc=disc, variables=variables, images=images,
              batch=batch)


@pytest.mark.parametrize("train", [False, True])
def test_discriminator(disc_inputs, train):
  """D as a whole at the test config in bfloat16."""
  config, disc, variables, images, batch = (
      disc_inputs[k] for k in ("config", "disc", "variables", "images",
                               "batch"))
  (want_logit, want_stats), new = disc(train=train).apply(
      variables, (images, batch), mutable=MUTABLE)
  d = xmc_net.Discriminator(config, generator=torch.Generator().manual_seed(0))
  bridge.load_jax_variables(d, variables)
  d.train(train)
  with torch.no_grad():
    logit, stats = d(torch.from_numpy(images),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
  assert logit.shape == (8, 1)
  assert_bf16_close(logit, want_logit, min_equal=0.5, max_ulps=2)
  assert set(stats) == set(want_stats) and len(stats) == 15
  for name, value in stats.items():
    assert value.dtype == torch.float32, name
    if name.endswith("_acc"):
      np.testing.assert_allclose(float(value), float(want_stats[name]),
                                 rtol=0, atol=1 / 8 + 1e-6, err_msg=name)
    else:
      np.testing.assert_allclose(float(value), float(want_stats[name]),
                                 rtol=2e-3, atol=1e-6, err_msg=name)
  assert_state_close(d, new)


@pytest.fixture(scope="module")
def critic_inputs():
  """The JAX initial state, a super-batch, and D's Adam ``mu`` after the
  JAX critic update in bfloat16."""
  j_config, config = _configs()
  super_batch = synthetic.super_batch(config, np.random.default_rng(0))
  sub = j_split(super_batch, j_config.d_step_per_g_step)[0]
  gen, disc, state = j_state(j_config, jax.random.PRNGKey(0), sub)
  critic = jax.jit(functools.partial(
      j_xmc_gan.train_d, generator=gen, discriminator=disc, config=j_config))
  new = critic(jax.random.PRNGKey(1), state, sub)
  return dict(state=jax.device_get(state), batch=super_batch,
              mu=_flat(new.d_opt_state[0].mu))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_critic_step_gradients(critic_inputs, use_pallas):
  """D's gradient of one bfloat16 critic update (``mu = (1 - beta1) g``
  after it), every kernel of D."""
  _, config = _configs()
  config.use_pallas = use_pallas
  s0 = critic_inputs["state"]
  state = create_train_state(config, "cpu", seed=0)
  bridge.load_jax_variables(state.generator, {
      "params": s0.g_params, **s0.generator_state})
  bridge.load_jax_variables(state.discriminator, {
      "params": s0.d_params, **s0.discriminator_state})
  sub = split_batch(bridge.to_tensors(critic_inputs["batch"]),
                    config.d_step_per_g_step)[0]
  xmc_gan.train_d(state, sub, config)
  mu, _, count = bridge.adam_state_to_jax(state.d_opt, state.discriminator)
  assert count == 1
  got, want = _flat(mu), critic_inputs["mu"]
  assert set(got) == set(want)
  kernels = [k for k in want if k.endswith("kernel")]
  assert len(kernels) >= 10
  for name in kernels:
    err = np.linalg.norm(got[name] - want[name])
    assert err <= 5e-2 * np.linalg.norm(want[name]), (
        f"{name}: relative error {err / np.linalg.norm(want[name]):.3e}")

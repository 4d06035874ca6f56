"""The port's models against the JAX package's, on bridged weights.

G and D at the test config (32 px, width 16) in float32, with and without
the scale-fused convs, in train and eval mode: outputs, D's 15 statistics,
and the new batch statistics and ``u0``.  A Bottleneck ResNet at 64 px
with a non-zero head exercises TF-SAME's asymmetric padding.

Tolerance: float32 on both sides, but XLA:CPU and PyTorch's CPU convs sum
in other orders through a dozen layers: 1e-4 relative and 1e-5 absolute
on outputs, 1e-4 absolute on the contrastive statistics (sums of a
batch's log-probabilities, of order 1 to 10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.models import get_architecture as j_arch
from xmcgan_image_generation_tpu.models import resnet_v1 as j_resnet
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.models import resnet_v1
from xmcgan_image_generation_tpu_torch.models import xmc_net
from xmcgan_image_generation_tpu_torch.utils import bridge

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
MUTABLE = ["batch_stats", "spectral_norm_stats"]


def close(got, want, rtol=RTOL, atol=ATOL):
  if isinstance(got, torch.Tensor):
    got = got.detach().float().numpy()
  np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                             atol=atol)


def _batch(config, n, seed=0):
  rng = np.random.default_rng(seed)
  s = config.image_size
  return {
      "image": rng.uniform(0, 1, (n, s, s, 3)).astype(np.float32),
      "embedding": rng.standard_normal((n, 17, 768)).astype(np.float32),
      "sentence_embedding": rng.standard_normal((n, 768)).astype(np.float32),
      "max_len": rng.integers(3, 18, (n, 1)).astype(np.float32),
      "z": rng.standard_normal((n, config.z_dim)).astype(np.float32),
  }


@pytest.fixture(scope="module", params=[True, False],
                ids=["scale_fused", "unfused"])
def setup(request):
  j_config = j_coco_xmc.get_test_config()
  j_config.dtype = "float32"
  j_config.scale_fused_convs = request.param
  config = coco_xmc.get_test_config()
  config.dtype = "float32"
  config.scale_fused_convs = request.param
  batch = _batch(config, 4)
  gen, disc = j_arch(j_config, jnp.float32)
  g_vars = jax.device_get(gen(train=False).init(
      jax.random.PRNGKey(1), (batch, batch["z"])))
  # Non-trivial running statistics, so that eval mode is exercised.
  rng = np.random.default_rng(5)
  g_vars["batch_stats"] = jax.tree_util.tree_map(
      lambda x: (x + rng.uniform(0.1, 0.5, x.shape)).astype(np.float32),
      g_vars["batch_stats"])
  images = np.concatenate([batch["image"], batch["image"][::-1]])
  d_vars = jax.device_get(disc(train=False).init(
      jax.random.PRNGKey(2), (images, batch)))
  return dict(config=config, batch=batch, images=images, gen=gen, disc=disc,
              g_vars=g_vars, d_vars=d_vars)


def _tensors(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("train", [True, False])
def test_generator(setup, train):
  s = setup
  want, new = s["gen"](train=train).apply(
      s["g_vars"], (s["batch"], s["batch"]["z"]), mutable=MUTABLE)
  g = xmc_net.Generator(s["config"],
                        generator=torch.Generator().manual_seed(0))
  bridge.load_jax_variables(g, s["g_vars"])
  g.train(train)
  batch = _tensors(s["batch"])
  got = g(batch, batch["z"])
  assert got.shape == (4, 32, 32, 3)
  close(got, want)
  stats = bridge.jax_from_state_dict(g.state_dict())["batch_stats"]
  want_stats = bridge.flatten(jax.device_get(new["batch_stats"]))
  for name, value in bridge.flatten(stats).items():
    close(value, want_stats[name])


@pytest.mark.parametrize("train", [True, False])
def test_discriminator(setup, train):
  s = setup
  (want_logit, want_stats), new = s["disc"](train=train).apply(
      s["d_vars"], (s["images"], s["batch"]), mutable=MUTABLE)
  d = xmc_net.Discriminator(s["config"],
                            generator=torch.Generator().manual_seed(0))
  bridge.load_jax_variables(d, s["d_vars"])
  d.train(train)
  logit, stats = d(torch.from_numpy(s["images"]), _tensors(s["batch"]))
  close(logit, want_logit)
  assert set(stats) == set(want_stats) and len(stats) == 15
  for name, value in stats.items():
    close(value, want_stats[name], rtol=1e-4, atol=1e-4)
  u0 = bridge.jax_from_state_dict(d.state_dict())["spectral_norm_stats"]
  want_u0 = bridge.flatten(jax.device_get(new["spectral_norm_stats"]))
  for name, value in bridge.flatten(u0).items():
    close(value, want_u0[name])


def test_discriminator_critic_only_heads(setup):
  """critic_only skips the heads the critic loss does not read."""
  s = setup
  d = xmc_net.Discriminator(s["config"],
                            generator=torch.Generator().manual_seed(0))
  bridge.load_jax_variables(d, s["d_vars"])
  d.eval()  # u0 stays put, so the two forwards see the same weights
  batch = _tensors(s["batch"])
  images = torch.from_numpy(s["images"])
  with torch.no_grad():
    logit, full = d(images, batch)
    logit_c, critic = d(images, batch, critic_only=True)
  torch.testing.assert_close(logit_c, logit)
  for name in ("real_word_loss", "real_sentence_loss"):
    torch.testing.assert_close(critic[name], full[name])
  for name in ("fake_word_loss", "fake_sentence_loss",
               "image_contrastive_loss"):
    assert float(critic[name]) == 0.0 and float(full[name]) != 0.0


def test_resnet_bottleneck_asymmetric_same_padding():
  j_model = j_resnet.ResNet(num_classes=10, stage_sizes=[1, 1, 1, 1],
                            block_cls=j_resnet.BottleneckBlock)
  x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(
      np.float32)
  variables = jax.device_get(j_model.init(jax.random.PRNGKey(0), x,
                                          train=False))
  rng = np.random.default_rng(8)
  variables["params"]["head"]["kernel"] = rng.standard_normal(
      variables["params"]["head"]["kernel"].shape).astype(np.float32) * 0.1
  variables["batch_stats"] = jax.tree_util.tree_map(
      lambda v: (v + rng.uniform(0.1, 0.5, v.shape)).astype(np.float32),
      variables["batch_stats"])
  want_pool, want_out = j_model.apply(variables, x, train=False)
  model = resnet_v1.ResNet(10, [1, 1, 1, 1],
                           generator=torch.Generator().manual_seed(0))
  bridge.load_jax_variables(model, variables)
  model.eval()
  pool, out = model(torch.from_numpy(x))
  assert pool.shape == (2, 2, 2, 2048)
  close(pool, want_pool, rtol=1e-4, atol=1e-4)
  close(out, want_out, rtol=1e-4, atol=1e-4)

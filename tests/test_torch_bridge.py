"""The weight bridge between the JAX package's trees and the port, and the
golden parameter counts of the port's models."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.models import get_architecture as j_arch
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.models import resnet_v1
from xmcgan_image_generation_tpu_torch.models import xmc_net
from xmcgan_image_generation_tpu_torch.utils import bridge

torch.set_num_threads(1)


def _count(module, buffers=False):
  tensors = module.buffers() if buffers else module.parameters()
  return sum(int(x.numel()) for x in tensors)


@pytest.fixture(scope="module")
def jax_variables():
  """A JAX G and D initialized at the test config (32 px, width 16)."""
  config = j_coco_xmc.get_test_config()
  config.dtype = "float32"
  config.scale_fused_convs = True
  gen, disc = j_arch(config, jnp.float32)
  batch = {"embedding": jnp.zeros((2, 17, 768)),
           "sentence_embedding": jnp.zeros((2, 768)),
           "max_len": jnp.full((2, 1), 9.0)}
  z = jnp.zeros((2, config.z_dim))
  g_vars = gen(train=False).init(jax.random.PRNGKey(1), (batch, z))
  images = jnp.zeros((4, 32, 32, 3))
  d_vars = disc(train=False).init(jax.random.PRNGKey(2), (images, batch))
  return jax.device_get(g_vars), jax.device_get(d_vars)


def _port_config():
  config = coco_xmc.get_test_config()
  config.dtype = "float32"
  config.scale_fused_convs = True
  return config


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_jax_to_port_to_jax_is_exact(jax_variables, net):
  variables = jax_variables[net == "discriminator"]
  cls = xmc_net.Generator if net == "generator" else xmc_net.Discriminator
  module = cls(_port_config(), generator=torch.Generator().manual_seed(0))
  bridge.load_jax_variables(module, variables)
  back = bridge.jax_from_state_dict(module.state_dict())
  assert set(back) == set(variables)
  for collection, tree in variables.items():
    want = bridge.flatten(tree)
    got = bridge.flatten(back[collection])
    assert set(got) == set(want)
    for name in want:
      np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_port_to_jax_to_port_is_exact(net):
  state = create_train_state(_port_config(), "cpu", seed=3)
  module = getattr(state, net)
  sd = module.state_dict()
  back = bridge.state_dict_from_jax(bridge.jax_from_state_dict(sd))
  assert set(back) == set(sd)
  for name, value in sd.items():
    torch.testing.assert_close(back[name], value, rtol=0, atol=0)


def test_adam_state_round_trip(jax_variables):
  params = jax_variables[0]["params"]
  rng = np.random.default_rng(0)
  mu = jax.tree_util.tree_map(
      lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
  nu = jax.tree_util.tree_map(lambda p: np.abs(p) + 1.0, mu)
  module = xmc_net.Generator(_port_config(),
                             generator=torch.Generator().manual_seed(0))
  opt = torch.optim.Adam(module.parameters(), lr=1e-4, betas=(0.5, 0.999))
  bridge.load_adam_state(opt, module, mu, nu, count=3)
  got_mu, got_nu, count = bridge.adam_state_to_jax(opt, module)
  assert count == 3
  for got, want in ((got_mu, mu), (got_nu, nu)):
    flat_got, flat_want = bridge.flatten(got), bridge.flatten(want)
    assert set(flat_got) == set(flat_want)
    for name in flat_want:
      np.testing.assert_array_equal(flat_got[name], flat_want[name])
  # The optax state of the same params has the same tree.
  opt_state = optax.adam(1e-4).init(params)
  assert (jax.tree_util.tree_structure(opt_state[0].mu)
          == jax.tree_util.tree_structure(mu))


def test_batch_layouts_round_trip():
  x = np.random.default_rng(1).standard_normal((2, 5, 6, 3))
  np.testing.assert_array_equal(
      bridge.nchw_to_nhwc(bridge.nhwc_to_nchw(x)), x)
  xt = torch.from_numpy(x)
  assert bridge.nhwc_to_nchw(xt).shape == (2, 3, 5, 6)
  torch.testing.assert_close(bridge.nchw_to_nhwc(bridge.nhwc_to_nchw(xt)),
                             xt, rtol=0, atol=0)


@pytest.mark.parametrize("net,params,buffers", [
    ("generator", 2_603_339, 2_496),
    ("discriminator", 2_650_033, 3_025),
])
def test_test_config_goldens(net, params, buffers):
  """The counts of tests/test_models.py (JAX, test config at 128 px):
  G buffers are the batch_stats, D buffers the spectral-norm ``u0``."""
  config = coco_xmc.get_test_config()
  config.image_size = 128
  cls = xmc_net.Generator if net == "generator" else xmc_net.Discriminator
  module = cls(config, generator=torch.Generator().manual_seed(0))
  assert _count(module) == params
  assert _count(module, buffers=True) == buffers


def test_resnet50_golden():
  model = resnet_v1.ResNet50(num_classes=1000,
                             generator=torch.Generator().manual_seed(0))
  assert _count(model) == 25_557_032

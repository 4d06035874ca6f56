"""Remat (``config.remat``) in the port's models against the port without
remat and against the JAX package's remat.

Config: the 256 px test configuration (`configs.coco_xmc_256.
get_test_config`: 64 px, width 16) in float32, with
``remat_min_resolution`` 0, 32 and 64 and both policies.  One train-mode
forward of G and of D on ``concat(real, G(z))`` and one backward of a
scalar of D's logit and 15 statistics.

Tolerances:
* port with remat against the port without: "full" recomputes the same
  float32 operations on the same inputs, so values, gradients, ``u0`` and
  the running averages are equal bit for bit; "conv" too in exact
  arithmetic, held within the JAX package's own tolerance for its conv
  policy (`tests/test_models.py`: 1e-6 relative on values, 1e-3 relative
  and 1e-4 (1 + max|g|) absolute on gradients), though it is also exact
  here;
* port with remat against JAX with remat, on bridged weights: the models'
  tolerance of `tests/test_torch_models.py` on values (1e-4 relative,
  1e-5 absolute; 1e-4 on the statistics) and on ``u0`` and the running
  averages; gradients as in `tests/test_torch_step.py`: 1e-3 relative
  plus 1e-3 of the tensor's largest magnitude (float32 sums in other
  orders through a dozen layers), and at least 1e-5 of the network's
  largest gradient for a gradient that is zero in exact arithmetic (a
  conv bias right before a BatchNorm) and float noise on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from xmcgan_image_generation_tpu.configs import coco_xmc_256 as j_coco_256
from xmcgan_image_generation_tpu.models import blocks as j_blocks
from xmcgan_image_generation_tpu.models import get_architecture as j_arch
from xmcgan_image_generation_tpu.models import xmc_net as j_xmc_net
from xmcgan_image_generation_tpu_torch.configs import coco_xmc_256
from xmcgan_image_generation_tpu_torch.data import synthetic
from xmcgan_image_generation_tpu_torch.engine import xmc_gan
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.models import xmc_net
from xmcgan_image_generation_tpu_torch.utils import bridge

torch.set_num_threads(1)

CASES = [(res, policy) for policy in ("full", "conv") for res in (0, 32, 64)]
IDS = [f"{policy}-min{res}" for res, policy in CASES]
MUTABLE = ["batch_stats", "spectral_norm_stats"]


def _config(jax_side=False, **overrides):
  config = (j_coco_256.get_test_config() if jax_side
            else coco_xmc_256.get_test_config())
  config.dtype = "float32"
  for k, v in overrides.items():
    setattr(config, k, v)
  return config


def _remat(res, policy):
  return dict(remat=True, remat_min_resolution=res, remat_policy=policy)


def _batch(n=2):
  config = _config()
  return synthetic.super_batch(config, np.random.default_rng(0), n=n)


def _loss(logit, stats):
  return (logit.float() ** 2).mean() + sum(stats.values())


def _port_pass(config):
  """G and D from fixed seeds, one train-mode forward and backward:
  the outputs, the gradients by parameter name and the state after."""
  g = xmc_net.Generator(config, generator=torch.Generator().manual_seed(0))
  d = xmc_net.Discriminator(config,
                            generator=torch.Generator().manual_seed(1))
  g.train()
  d.train()
  batch = bridge.to_tensors(_batch())
  image = batch["image"].float() / 255.0
  fake = g(batch, batch["z"])
  logit, stats = d(torch.cat([image, fake]), batch)
  named = [(f"g.{n}", p) for n, p in g.named_parameters()] + [
      (f"d.{n}", p) for n, p in d.named_parameters()]
  grads = torch.autograd.grad(_loss(logit, stats), [p for _, p in named])
  state = {**{f"g.{k}": v for k, v in g.state_dict().items()},
           **{f"d.{k}": v for k, v in d.state_dict().items()}}
  return dict(fake=fake.detach(), logit=logit.detach(),
              stats={k: v.detach() for k, v in stats.items()},
              grads={n: gr for (n, _), gr in zip(named, grads)},
              state={k: v.clone() for k, v in state.items()}, g=g, d=d)


@pytest.fixture(scope="module")
def plain():
  return _port_pass(_config())


@pytest.mark.parametrize("res,policy", CASES, ids=IDS)
def test_remat_keeps_values_gradients_and_state(plain, res, policy):
  got = _port_pass(_config(**_remat(res, policy)))
  assert set(got["state"]) == set(plain["state"])   # names unchanged
  if policy == "full":
    torch.testing.assert_close(got["fake"], plain["fake"], rtol=0, atol=0)
    torch.testing.assert_close(got["logit"], plain["logit"], rtol=0, atol=0)
    for k, v in plain["stats"].items():
      torch.testing.assert_close(got["stats"][k], v, rtol=0, atol=0)
    for k, v in plain["grads"].items():
      torch.testing.assert_close(got["grads"][k], v, rtol=0, atol=0, msg=k)
  else:
    torch.testing.assert_close(got["fake"], plain["fake"], rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(got["logit"], plain["logit"], rtol=1e-6,
                               atol=0)
    for k, v in plain["grads"].items():
      tol = 1e-4 * (1.0 + float(v.abs().max()))
      torch.testing.assert_close(got["grads"][k], v, rtol=1e-3, atol=tol,
                                 msg=k)
  # u0 advanced once and the running averages written once, by the
  # forward alone: bit for bit under either policy.
  for k, v in plain["state"].items():
    torch.testing.assert_close(got["state"][k], v, rtol=0, atol=0, msg=k)


def _jax_sides(config):
  """The block sides of the JAX package's models, as its code computes
  them: G's blocks 4 * 2 ** (i + 1), D's the image size, then the
  running resolution."""
  gen = {f"GenBlock_{i}": 4 * 2 ** (i + 1) for i in range(2)}
  channels = j_xmc_net._GEN_CHANNELS[config.image_size]
  gen.update({f"GenSpatialBlockFused_{i - 2}": 4 * 2 ** (i + 1)
              for i in range(2, len(channels))})
  disc = {"DiscOptimizedBlock_0": config.image_size}
  resolution = config.image_size // 2
  for i, down in enumerate(j_xmc_net._DISC_DOWNSAMPLE[config.image_size]):
    disc[f"DiscBlock_{i}"] = resolution
    resolution //= 2 if down else 1
  return gen, disc


@pytest.mark.parametrize("res,policy", CASES, ids=IDS)
def test_remat_wraps_the_blocks_jax_wraps(plain, res, policy):
  j_config = _config(jax_side=True, **_remat(res, policy))
  gen_sides, disc_sides = _jax_sides(j_config)
  g = xmc_net.Generator(_config(**_remat(res, policy)), device="meta")
  d = xmc_net.Discriminator(_config(**_remat(res, policy)), device="meta")
  for net, sides in ((g, gen_sides), (d, disc_sides)):
    for name, side in sides.items():
      jax_wraps = j_xmc_net._maybe_remat(
          j_config, j_blocks.DiscBlock, side) is not j_blocks.DiscBlock
      assert getattr(net, name).remat_policy == (policy if jax_wraps
                                                 else None), name


def test_256_config_rematerializes_its_largest_scale():
  config = coco_xmc_256.get_config()
  g = xmc_net.Generator(config, device="meta")
  d = xmc_net.Discriminator(config, device="meta")
  marked = [n for net in (g, d) for n, m in net.named_children()
            if getattr(m, "remat_policy", None)]
  assert marked == ["GenSpatialBlockFused_3", "DiscOptimizedBlock_0"]


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "on"])
def test_unknown_remat_policy_raises(remat):
  with pytest.raises(ValueError, match="remat_policy"):
    xmc_net.Discriminator(_config(remat=remat, remat_policy="everything"),
                          device="meta")


class _CountConvs(TorchDispatchMode):

  def __init__(self):
    super().__init__()
    self.count = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    if func == torch.ops.aten.convolution.default:
      self.count += 1
    return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,reruns", [("full", True), ("conv", False)])
def test_conv_policy_saves_the_convolutions(policy, reruns):
  """"full" runs the block's convolutions again in the backward; "conv"
  hands back the forward's outputs and runs none."""
  config = _config(**_remat(0, policy))
  d = xmc_net.Discriminator(config,
                            generator=torch.Generator().manual_seed(1))
  d.train()
  batch = bridge.to_tensors(_batch())
  image = batch["image"].float() / 255.0
  logit, stats = d(torch.cat([image, image.flip(0)]), batch)
  loss = _loss(logit, stats)
  counter = _CountConvs()
  with counter:
    torch.autograd.grad(loss, list(d.parameters()))
  assert (counter.count > 0) == reruns


@pytest.mark.parametrize("policy", ["full", "conv"])
def test_joint_update_with_remat_is_the_update_without(policy):
  """The joint G+D update pulls two gradients through D: the recomputed
  regions serve both, and the update is the one without remat."""
  batch = bridge.to_tensors(_batch(4))
  states = []
  for overrides in ({}, _remat(0, policy)):
    config = _config(**overrides)
    state = create_train_state(config, "cpu", seed=0)
    xmc_gan.train_g_d(state, batch, config)
    states.append(state)
  for got, want in ((states[1].generator, states[0].generator),
                    (states[1].discriminator, states[0].discriminator)):
    for (k, v), (k2, w) in zip(got.state_dict().items(),
                               want.state_dict().items()):
      assert k == k2
      torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)


@pytest.fixture(scope="module")
def jax_models():
  """JAX variables of G and D at the test configuration (remat off)."""
  j_config = _config(jax_side=True)
  batch = _batch()
  gen, disc = j_arch(j_config, jnp.float32)
  g_vars = jax.device_get(gen(train=False).init(
      jax.random.PRNGKey(1), (batch, batch["z"])))
  image = batch["image"].astype(np.float32) / 255.0
  d_vars = jax.device_get(disc(train=False).init(
      jax.random.PRNGKey(2), (np.concatenate([image, image]), batch)))
  return dict(g_vars=g_vars, d_vars=d_vars, batch=batch, image=image)


@pytest.mark.parametrize("policy", ["full", "conv"])
def test_port_remat_matches_jax_remat(jax_models, policy):
  """Both packages with remat of every block: G's output, D's logit and
  statistics, the parameter gradients of the same scalar, the new batch
  statistics and ``u0``."""
  j_config = _config(jax_side=True, **_remat(0, policy))
  gen, disc = j_arch(j_config, jnp.float32)
  g_vars, d_vars = jax_models["g_vars"], jax_models["d_vars"]
  batch, image = jax_models["batch"], jax_models["image"]

  def loss_fn(g_params, d_params):
    fake, new_g = gen(train=True).apply(
        {**g_vars, "params": g_params}, (batch, batch["z"]),
        mutable=MUTABLE)
    (logit, stats), new_d = disc(train=True).apply(
        {**d_vars, "params": d_params},
        (jnp.concatenate([image, fake]), batch), mutable=MUTABLE)
    loss = jnp.mean(logit ** 2) + sum(stats.values())
    return loss, (fake, logit, stats, new_g, new_d)

  (_, (fake, logit, stats, new_g, new_d)), (g_grad, d_grad) = jax.jit(
      jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
          g_vars["params"], d_vars["params"])

  config = _config(**_remat(0, policy))
  g = xmc_net.Generator(config, generator=torch.Generator().manual_seed(0))
  d = xmc_net.Discriminator(config,
                            generator=torch.Generator().manual_seed(0))
  bridge.load_jax_variables(g, g_vars)
  bridge.load_jax_variables(d, d_vars)
  g.train()
  d.train()
  t_batch = bridge.to_tensors(batch)
  t_fake = g(t_batch, t_batch["z"])
  t_logit, t_stats = d(torch.cat([torch.from_numpy(image), t_fake]), t_batch)
  t_g_grads = torch.autograd.grad(_loss(t_logit, t_stats),
                                  list(g.parameters()) + list(d.parameters()))
  n_g = len(list(g.parameters()))

  def close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)

  close(t_fake, fake)
  close(t_logit, logit)
  for k, v in t_stats.items():
    close(v, stats[k], atol=1e-4)
  for module, grads, want in (
      (g, t_g_grads[:n_g], g_grad), (d, t_g_grads[n_g:], d_grad)):
    got = bridge.flatten(bridge.tensors_to_jax(
        {n: gr for (n, _), gr in zip(module.named_parameters(), grads)}))
    want = {k: np.asarray(w)
            for k, w in bridge.flatten(jax.device_get(want)).items()}
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
      np.testing.assert_allclose(
          got[name], w, rtol=1e-3,
          atol=max(1e-3 * float(np.abs(w).max()), 1e-5 * top), err_msg=name)
  for module, new, collection in ((g, new_g, "batch_stats"),
                                  (d, new_d, "spectral_norm_stats")):
    got = bridge.flatten(bridge.jax_from_state_dict(
        module.state_dict())[collection])
    for name, w in bridge.flatten(jax.device_get(new[collection])).items():
      close(torch.from_numpy(got[name]), w)

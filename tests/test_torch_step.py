"""The slice as a whole: one outer training step of the port against the
jitted JAX ``engine.step.train_step``.

Both start from the same state (the JAX initialization, bridged into the
port) and take one outer step on the same numpy-seeded super-batch of
2 x 2 examples, ``z`` included: one critic update, then one joint G+D
update.  Config: the test config (32 px, width 16) with float32 compute,
the scale-fused convs and the dilated up-convs.  The port runs twice,
with ``use_pallas`` off (einsum heads) and on (the kernels' plain
versions, on the CPU); the JAX step runs the einsum heads.

Tolerances, float32 on both sides (XLA:CPU and PyTorch sum in other
orders):
* losses, batch statistics: 1e-4 relative;
* gradients and Adam slots: 1e-3 relative, plus 1e-3 of the tensor's
  largest magnitude absolute (gradient of a sum over layers); a gradient
  that is zero in exact arithmetic (a conv bias right before a BatchNorm)
  is float noise of ~1e-8 on both sides, so the absolute tolerance is at
  least 1e-5 of the largest gradient of the network (1e-10 of the largest
  ``nu``, which holds squares);
* parameters: the first Adam steps move each weight by about lr * sign(g),
  so a weight whose gradient is ~0 may move either way in the two
  frameworks: absolute tolerance 2 lr per Adam step (G: 1 step at 1e-4,
  D: 2 steps at 4e-4);
* ``u0`` (advanced twice, the second time on the updated D): 1e-3;
* EMA: 0.999 p0 + 0.001 p1, so a tenth of G's parameter tolerance.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.engine import create_train_state as j_state
from xmcgan_image_generation_tpu.engine.step import split_batch as j_split
from xmcgan_image_generation_tpu.engine.step import train_step as j_step
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.data import synthetic
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.engine.step import train_step
from xmcgan_image_generation_tpu_torch.utils import bridge

torch.set_num_threads(1)

OVERRIDES = dict(dtype="float32", scale_fused_convs=True,
                 upconv_method="dilated")
LOSSES = ("d_loss", "g_loss", "c_loss_d", "c_loss_g", "c_loss_g_pretrained")


def _configs():
  j_config = j_coco_xmc.get_test_config()
  config = coco_xmc.get_test_config()
  for k, v in OVERRIDES.items():
    setattr(j_config, k, v)
    setattr(config, k, v)
  return j_config, config


def _super_batch():
  _, config = _configs()
  return synthetic.super_batch(config, np.random.default_rng(0))


def _flat(tree):
  return {k: np.asarray(v, np.float32)
          for k, v in bridge.flatten(jax.device_get(tree)).items()}


@pytest.fixture(scope="module")
def initial():
  """The JAX initial state (shared by both sides)."""
  j_config, _ = _configs()
  super_batch = _super_batch()
  init_batch = j_split(super_batch, j_config.d_step_per_g_step)[0]
  gen, disc, state = j_state(j_config, jax.random.PRNGKey(0), init_batch)
  return dict(gen=gen, disc=disc, state=state, batch=super_batch)


@pytest.fixture(scope="module")
def jax_result(initial):
  j_config, _ = _configs()
  step = jax.jit(functools.partial(
      j_step, generator=initial["gen"], discriminator=initial["disc"],
      config=j_config, additional_data={}))
  new, metrics = step(jax.random.PRNGKey(1), initial["state"],
                      initial["batch"])
  new = jax.device_get(new)
  return dict(
      losses={k: float(v) for k, v in metrics.items()},
      g_params=_flat(new.g_params), d_params=_flat(new.d_params),
      g_mu=_flat(new.g_opt_state[0].mu), g_nu=_flat(new.g_opt_state[0].nu),
      d_mu=_flat(new.d_opt_state[0].mu), d_nu=_flat(new.d_opt_state[0].nu),
      g_count=int(new.g_opt_state[0].count),
      d_count=int(new.d_opt_state[0].count),
      batch_stats=_flat(new.generator_state["batch_stats"]),
      u0=_flat(new.discriminator_state["spectral_norm_stats"]),
      ema=_flat(new.ema_params))


@pytest.fixture(scope="module", params=[False, True],
                ids=["einsum", "use_pallas"])
def port_result(request, initial):
  _, config = _configs()
  config.use_pallas = request.param
  s0 = jax.device_get(initial["state"])
  state = create_train_state(config, "cpu", seed=0)
  bridge.load_jax_variables(state.generator, {
      "params": s0.g_params, **s0.generator_state})
  bridge.load_jax_variables(state.discriminator, {
      "params": s0.d_params, **s0.discriminator_state})
  for opt, module, opt_state in ((state.g_opt, state.generator,
                                  s0.g_opt_state),
                                 (state.d_opt, state.discriminator,
                                  s0.d_opt_state)):
    adam = opt_state[0]
    bridge.load_adam_state(opt, module, adam.mu, adam.nu, int(adam.count))
  state.ema_params = bridge.tree_to_torch(s0.ema_params)
  batch = bridge.to_tensors(initial["batch"])
  state, metrics = train_step(state, batch, config, {})
  g_mu, g_nu, g_count = bridge.adam_state_to_jax(state.g_opt,
                                                 state.generator)
  d_mu, d_nu, d_count = bridge.adam_state_to_jax(state.d_opt,
                                                 state.discriminator)
  g_vars = bridge.jax_from_state_dict(state.generator.state_dict())
  d_vars = bridge.jax_from_state_dict(state.discriminator.state_dict())
  return dict(
      losses={k: float(v) for k, v in metrics.items()},
      g_params=_flat(g_vars["params"]), d_params=_flat(d_vars["params"]),
      g_mu=_flat(g_mu), g_nu=_flat(g_nu), d_mu=_flat(d_mu), d_nu=_flat(d_nu),
      g_count=g_count, d_count=d_count,
      batch_stats=_flat(g_vars["batch_stats"]),
      u0=_flat(d_vars["spectral_norm_stats"]),
      ema=_flat(bridge.tensors_to_jax(state.ema_params)), step=state.step)


def _close_trees(got, want, rtol, atol=0.0, scaled=0.0, floor=0.0):
  """``floor`` is a fraction of the largest magnitude in the whole tree."""
  assert set(got) == set(want)
  top = max(float(np.abs(v).max()) for v in want.values())
  for name in want:
    tol = max(atol + scaled * float(np.abs(want[name]).max()), floor * top)
    np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=tol,
                               err_msg=name)


def test_losses(port_result, jax_result):
  assert port_result["step"] == 1
  assert set(port_result["losses"]) == set(LOSSES) == set(
      jax_result["losses"])
  for k in LOSSES:
    np.testing.assert_allclose(port_result["losses"][k],
                               jax_result["losses"][k], rtol=1e-4,
                               atol=1e-5, err_msg=k)


def test_generator_gradients(port_result, jax_result):
  """After one Adam step from zero slots, mu = (1 - beta1) g."""
  beta1 = coco_xmc.get_config().beta1
  got = {k: v / (1 - beta1) for k, v in port_result["g_mu"].items()}
  want = {k: v / (1 - beta1) for k, v in jax_result["g_mu"].items()}
  _close_trees(got, want, rtol=1e-3, scaled=1e-3, floor=1e-5)


@pytest.mark.parametrize("slot", ["g_mu", "g_nu", "d_mu", "d_nu"])
def test_adam_slots(port_result, jax_result, slot):
  floor = 1e-10 if slot.endswith("nu") else 1e-5
  _close_trees(port_result[slot], jax_result[slot], rtol=1e-3, scaled=1e-3,
               floor=floor)


def test_adam_counts(port_result, jax_result):
  # G: one joint update; D: one critic and one joint update.
  assert port_result["g_count"] == jax_result["g_count"] == 1
  assert port_result["d_count"] == jax_result["d_count"] == 2


@pytest.mark.parametrize("net,lr,steps", [("g", 1e-4, 1), ("d", 4e-4, 2)])
def test_params(port_result, jax_result, net, lr, steps):
  _close_trees(port_result[f"{net}_params"], jax_result[f"{net}_params"],
               rtol=0, atol=2 * lr * steps)


def test_spectral_norm_u0(port_result, jax_result):
  _close_trees(port_result["u0"], jax_result["u0"], rtol=0, atol=1e-3)


def test_batch_stats(port_result, jax_result):
  _close_trees(port_result["batch_stats"], jax_result["batch_stats"],
               rtol=1e-4, atol=1e-5)


def test_ema(port_result, jax_result):
  _close_trees(port_result["ema"], jax_result["ema"], rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def jax_critic_mu(initial):
  """D's Adam ``mu`` after the JAX critic update alone."""
  from xmcgan_image_generation_tpu.engine import xmc_gan as j_xmc_gan

  j_config, _ = _configs()
  sub = j_split(initial["batch"], j_config.d_step_per_g_step)[0]
  critic = jax.jit(functools.partial(
      j_xmc_gan.train_d, generator=initial["gen"],
      discriminator=initial["disc"], config=j_config))
  new = critic(jax.random.PRNGKey(1), initial["state"], sub)
  return _flat(jax.device_get(new.d_opt_state[0].mu))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_discriminator_gradients(initial, jax_critic_mu, use_pallas):
  """D's gradient of the critic update (mu = (1 - beta1) g after it)."""
  from xmcgan_image_generation_tpu_torch.engine import xmc_gan
  from xmcgan_image_generation_tpu_torch.engine.step import split_batch

  _, config = _configs()
  config.use_pallas = use_pallas
  s0 = jax.device_get(initial["state"])
  state = create_train_state(config, "cpu", seed=0)
  bridge.load_jax_variables(state.generator, {
      "params": s0.g_params, **s0.generator_state})
  bridge.load_jax_variables(state.discriminator, {
      "params": s0.d_params, **s0.discriminator_state})
  sub = split_batch(bridge.to_tensors(initial["batch"]),
                    config.d_step_per_g_step)[0]
  xmc_gan.train_d(state, sub, config)
  mu, _, count = bridge.adam_state_to_jax(state.d_opt, state.discriminator)
  assert count == 1
  beta1 = config.beta1
  got = {k: v / (1 - beta1) for k, v in _flat(mu).items()}
  want = {k: v / (1 - beta1) for k, v in jax_critic_mu.items()}
  _close_trees(got, want, rtol=1e-3, scaled=1e-3, floor=1e-5)

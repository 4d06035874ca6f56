"""Gradient accumulation (``config.grad_accum_steps``): one outer step of
the port against the jitted JAX ``engine.step.train_step`` with the same
k.

The outer step (``32px``: the test config, 32 px, width 16, in float32
with the scale-fused convs and the dilated up-convs, as
`tests/test_torch_step.py`): both start from the same state (the JAX
initialization, bridged into the port) and take one outer step on the
same numpy-seeded super-batch of 2 x 4 examples, ``z`` included, with
k = 2: each of the critic update and the joint G+D update takes its
gradients on two microbatches of 2 in turn, averages them and steps its
Adam once.

Each update alone, from the initial state (``32px``, and
``256px_remat``: the 256 px file's test config, 64 px, with remat of its
largest scale, ``remat_min_resolution=64``, the slice as a whole, on a
super-batch of 2 x 8, microbatches of 4): the critic update on the
super-batch's first half, the joint update on its second.  At 64 px the
model sits within float noise of ReLU kinks on microbatches of 2: after
the critic update, the 4e-6 by which the packages' fake images differ
moves D's gradient by 0.75 % in ``DiscBlock_2.SpectralConv_0`` (the port
alone does the same for 1e-5 of noise on its own fake images), and the
JAX joint update alone moves G's ``Dense_1.bias`` slot by 5.6e-4 (2.3 %)
between XLA's optimization levels 0 (`tests/conftest.py`) and the
default.  So the 64 px outer step is not held whole, and its
microbatches are 4.

The port runs its einsum heads and, on the CPU, the kernels' plain
versions (``use_pallas``); the JAX step runs the einsum heads.

Tolerances, float32 on both sides, as `tests/test_torch_step.py` states
them: losses and batch statistics 1e-4 relative; gradients and Adam
slots 1e-3 relative plus 1e-3 of the tensor's largest magnitude, at least
1e-5 of the network's largest gradient (1e-10 of the largest ``nu``);
parameters 2 lr per Adam step (the outer step: G 1 step at 1e-4, D 2 at
4e-4; the joint update: 1 each); ``u0`` 1e-3 (advanced k times a D
forward); EMA 2e-5.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.configs import coco_xmc_256 as j_coco_256
from xmcgan_image_generation_tpu.engine import create_train_state as j_state
from xmcgan_image_generation_tpu.engine import xmc_gan as j_xmc_gan
from xmcgan_image_generation_tpu.engine.step import split_batch as j_split
from xmcgan_image_generation_tpu.engine.step import (
    stack_microbatches as j_stack,
)
from xmcgan_image_generation_tpu.engine.step import train_step as j_step
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.configs import coco_xmc_256
from xmcgan_image_generation_tpu_torch.data import synthetic
from xmcgan_image_generation_tpu_torch.engine import xmc_gan
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.engine.step import (
    split_batch,
    stack_microbatches,
    train_step,
)
from xmcgan_image_generation_tpu_torch.utils import bridge

torch.set_num_threads(1)

K = 2
BATCH = {"32px": 4, "256px_remat": 8}
LOSSES = ("d_loss", "g_loss", "c_loss_d", "c_loss_g", "c_loss_g_pretrained")
CONFIGS = {
    "32px": ((j_coco_xmc, coco_xmc),
             dict(scale_fused_convs=True, upconv_method="dilated")),
    "256px_remat": ((j_coco_256, coco_xmc_256),
                    dict(remat=True, remat_min_resolution=64)),
}


def _configs(name):
  (j_module, module), overrides = CONFIGS[name]
  j_config, config = j_module.get_test_config(), module.get_test_config()
  for c in (j_config, config):
    for k, v in dict(overrides, dtype="float32", batch_size=BATCH[name],
                     grad_accum_steps=K).items():
      setattr(c, k, v)
  return j_config, config


def _flat(tree):
  return {k: np.asarray(v, np.float32)
          for k, v in bridge.flatten(jax.device_get(tree)).items()}


def _close_trees(got, want, rtol, atol=0.0, scaled=0.0, floor=0.0):
  """``floor`` is a fraction of the largest magnitude in the whole tree."""
  assert set(got) == set(want)
  top = max(float(np.abs(v).max()) for v in want.values())
  for name in want:
    tol = max(atol + scaled * float(np.abs(want[name]).max()), floor * top)
    np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=tol,
                               err_msg=name)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def initial(request):
  return _initial(request.param)


@pytest.fixture(scope="module")
def initial_32():
  return _initial("32px")


def _initial(name):
  """The JAX initial state of the configuration (shared by both sides)."""
  j_config, config = _configs(name)
  super_batch = synthetic.super_batch(config, np.random.default_rng(0))
  init_batch = j_split(super_batch, j_config.d_step_per_g_step)[0]
  gen, disc, state = j_state(j_config, jax.random.PRNGKey(0), init_batch)
  return dict(name=name, gen=gen, disc=disc, state=state, batch=super_batch)


def _jax_flat(new):
  return dict(
      g_params=_flat(new.g_params), d_params=_flat(new.d_params),
      g_mu=_flat(new.g_opt_state[0].mu), g_nu=_flat(new.g_opt_state[0].nu),
      d_mu=_flat(new.d_opt_state[0].mu), d_nu=_flat(new.d_opt_state[0].nu),
      g_count=int(new.g_opt_state[0].count),
      d_count=int(new.d_opt_state[0].count),
      batch_stats=_flat(new.generator_state["batch_stats"]),
      u0=_flat(new.discriminator_state["spectral_norm_stats"]),
      ema=_flat(new.ema_params))


def _port_flat(state):
  g_mu, g_nu, g_count = bridge.adam_state_to_jax(state.g_opt,
                                                 state.generator)
  d_mu, d_nu, d_count = bridge.adam_state_to_jax(state.d_opt,
                                                 state.discriminator)
  g_vars = bridge.jax_from_state_dict(state.generator.state_dict())
  d_vars = bridge.jax_from_state_dict(state.discriminator.state_dict())
  return dict(
      g_params=_flat(g_vars["params"]), d_params=_flat(d_vars["params"]),
      g_mu=_flat(g_mu), g_nu=_flat(g_nu), d_mu=_flat(d_mu), d_nu=_flat(d_nu),
      g_count=g_count, d_count=d_count,
      batch_stats=_flat(g_vars["batch_stats"]),
      u0=_flat(d_vars["spectral_norm_stats"]),
      ema=_flat(bridge.tensors_to_jax(state.ema_params)), step=state.step)


@pytest.fixture(scope="module")
def jax_result(initial_32):
  initial = initial_32
  j_config, _ = _configs(initial["name"])
  step = jax.jit(functools.partial(
      j_step, generator=initial["gen"], discriminator=initial["disc"],
      config=j_config, additional_data={}))
  new, metrics = step(jax.random.PRNGKey(1), initial["state"],
                      initial["batch"])
  return dict(losses={k: float(v) for k, v in metrics.items()},
              **_jax_flat(jax.device_get(new)))


def _port_state(initial, config):
  s0 = jax.device_get(initial["state"])
  state = create_train_state(config, "cpu", seed=0)
  bridge.load_jax_variables(state.generator, {
      "params": s0.g_params, **s0.generator_state})
  bridge.load_jax_variables(state.discriminator, {
      "params": s0.d_params, **s0.discriminator_state})
  state.ema_params = bridge.tree_to_torch(s0.ema_params)
  return state


@pytest.fixture(scope="module", params=[False, True],
                ids=["einsum", "use_pallas"])
def port_result(request, initial_32):
  initial = initial_32
  _, config = _configs(initial["name"])
  config.use_pallas = request.param
  state = _port_state(initial, config)
  state, metrics = train_step(state, bridge.to_tensors(initial["batch"]),
                              config, {})
  return dict(losses={k: float(v) for k, v in metrics.items()},
              **_port_flat(state))


@pytest.fixture(scope="module", params=[False, True],
                ids=["einsum", "use_pallas"])
def joint(request, initial):
  """The joint update (k = 2) of each package from the initial state, on
  the super-batch's second half."""
  j_config, config = _configs(initial["name"])
  config.use_pallas = request.param
  update = jax.jit(functools.partial(
      j_xmc_gan.train_g_d, generator=initial["gen"],
      discriminator=initial["disc"], config=j_config, additional_data={}))
  new, j_losses = update(jax.random.PRNGKey(1), initial["state"],
                         j_split(initial["batch"], 2)[1])
  state = _port_state(initial, config)
  sub = split_batch(bridge.to_tensors(initial["batch"]),
                    config.d_step_per_g_step)[1]
  losses = xmc_gan.train_g_d(state, sub, config, {})
  return (dict(losses={k: float(v) for k, v in losses.items()},
               **_port_flat(state)),
          dict(losses={k: float(v) for k, v in j_losses.items()},
               **_jax_flat(jax.device_get(new))))


def test_losses(port_result, jax_result):
  assert port_result["step"] == 1
  assert set(port_result["losses"]) == set(LOSSES) == set(
      jax_result["losses"])
  for k in LOSSES:
    np.testing.assert_allclose(port_result["losses"][k],
                               jax_result["losses"][k], rtol=1e-4,
                               atol=1e-5, err_msg=k)


def test_generator_gradients(port_result, jax_result):
  """After one Adam step from zero slots, mu = (1 - beta1) g: the mean
  of the two microbatches' gradients."""
  beta1 = coco_xmc.get_config().beta1
  got = {k: v / (1 - beta1) for k, v in port_result["g_mu"].items()}
  want = {k: v / (1 - beta1) for k, v in jax_result["g_mu"].items()}
  _close_trees(got, want, rtol=1e-3, scaled=1e-3, floor=1e-5)


@pytest.mark.parametrize("slot", ["g_mu", "g_nu", "d_mu", "d_nu"])
def test_adam_slots(port_result, jax_result, slot):
  floor = 1e-10 if slot.endswith("nu") else 1e-5
  _close_trees(port_result[slot], jax_result[slot], rtol=1e-3, scaled=1e-3,
               floor=floor)


def test_each_adam_steps_once_an_update(port_result, jax_result):
  # G: one joint update; D: one critic and one joint update; each applied
  # once on the mean of its K microbatches' gradients.
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


def test_joint_update_losses(joint):
  port, jax_side = joint
  for k in LOSSES:
    np.testing.assert_allclose(port["losses"][k], jax_side["losses"][k],
                               rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("slot", ["g_mu", "g_nu", "d_mu", "d_nu"])
def test_joint_update_adam_slots(joint, slot):
  """From zero slots, mu = (1 - beta1) g: the mean of the two
  microbatches' gradients."""
  port, jax_side = joint
  floor = 1e-10 if slot.endswith("nu") else 1e-5
  _close_trees(port[slot], jax_side[slot], rtol=1e-3, scaled=1e-3,
               floor=floor)


def test_joint_update_steps_each_adam_once(joint):
  port, jax_side = joint
  assert port["g_count"] == jax_side["g_count"] == 1
  assert port["d_count"] == jax_side["d_count"] == 1


@pytest.mark.parametrize("net,lr", [("g", 1e-4), ("d", 4e-4)])
def test_joint_update_params(joint, net, lr):
  port, jax_side = joint
  _close_trees(port[f"{net}_params"], jax_side[f"{net}_params"], rtol=0,
               atol=2 * lr)


@pytest.mark.parametrize("what,rtol,atol", [
    ("u0", 0, 1e-3), ("batch_stats", 1e-4, 1e-5), ("ema", 0, 2e-5)])
def test_joint_update_state(joint, what, rtol, atol):
  port, jax_side = joint
  _close_trees(port[what], jax_side[what], rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def jax_critic(initial):
  """D's Adam ``mu`` and ``u0`` after the JAX critic update alone."""
  j_config, _ = _configs(initial["name"])
  sub = j_split(initial["batch"], j_config.d_step_per_g_step)[0]
  critic = jax.jit(functools.partial(
      j_xmc_gan.train_d, generator=initial["gen"],
      discriminator=initial["disc"], config=j_config))
  new = jax.device_get(critic(jax.random.PRNGKey(1), initial["state"], sub))
  return dict(mu=_flat(new.d_opt_state[0].mu),
              u0=_flat(new.discriminator_state["spectral_norm_stats"]),
              batch_stats=_flat(new.generator_state["batch_stats"]))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_critic_update(initial, jax_critic, use_pallas):
  """The critic update alone: D's mean gradient, ``u0`` advanced once per
  microbatch, and G's batch statistics left as they were."""
  _, config = _configs(initial["name"])
  config.use_pallas = use_pallas
  state = _port_state(initial, config)
  sub = split_batch(bridge.to_tensors(initial["batch"]),
                    config.d_step_per_g_step)[0]
  xmc_gan.train_d(state, sub, config)
  mu, _, count = bridge.adam_state_to_jax(state.d_opt, state.discriminator)
  assert count == 1
  beta1 = config.beta1
  got = {k: v / (1 - beta1) for k, v in _flat(mu).items()}
  want = {k: v / (1 - beta1) for k, v in jax_critic["mu"].items()}
  _close_trees(got, want, rtol=1e-3, scaled=1e-3, floor=1e-5)
  d_vars = bridge.jax_from_state_dict(state.discriminator.state_dict())
  _close_trees(_flat(d_vars["spectral_norm_stats"]), jax_critic["u0"],
               rtol=0, atol=1e-3)
  g_vars = bridge.jax_from_state_dict(state.generator.state_dict())
  _close_trees(_flat(g_vars["batch_stats"]), jax_critic["batch_stats"],
               rtol=0, atol=0)


def test_microbatches_are_split_batch_rows():
  batch = {"x": np.arange(24, dtype=np.float32).reshape(12, 2)}
  got = stack_microbatches(bridge.to_tensors(batch), 3)["x"].numpy()
  np.testing.assert_array_equal(got, np.asarray(j_stack(batch, 3)["x"]))
  parts = split_batch(bridge.to_tensors(batch), 3)
  for i in range(3):
    np.testing.assert_array_equal(got[i], parts[i]["x"].numpy())


def test_a_non_dividing_k_raises():
  _, config = _configs("32px")
  config.grad_accum_steps = 3
  batch = synthetic.super_batch(config, np.random.default_rng(0))
  with pytest.raises(ValueError, match="not divisible by grad_accum_steps"):
    j_stack(j_split(batch, 2)[0], 3)
  with pytest.raises(ValueError, match="not divisible by grad_accum_steps"):
    stack_microbatches(split_batch(bridge.to_tensors(batch), 2)[0], 3)
  state = create_train_state(config, "cpu", seed=0)
  with pytest.raises(ValueError, match="not divisible by grad_accum_steps"):
    train_step(state, bridge.to_tensors(batch), config, {})

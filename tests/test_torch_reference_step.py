"""One outer training step of the port with the spectral reference-layout
generator (``g_spectral_norm=True``) against the JAX package's, and G's
state in the critic update.

Both start from the JAX initialization (bridged into the port) and take
one outer step on the same numpy-seeded super-batch of 2 x 2 examples:
one critic update (``train_d``), then one joint G+D update
(``train_g_d``), which is what JAX's ``engine.step.train_step`` runs;
the JAX side jits each update.  Config: the test config (32 px, width
16), float32, the scale-fused dilated up-convs, spectral norm in G and
D.  Tolerances are ``tests/test_torch_step.py``'s:

* losses, running averages: 1e-4 relative;
* gradients and Adam slots: 1e-3 relative, plus 1e-3 of the tensor's
  largest magnitude absolute and at least 1e-5 of the network's largest
  gradient (1e-10 of the largest ``nu``);
* parameters: 2 lr per Adam step absolute;
* ``u0``: 1e-3 (D's advanced twice, G's once, by the joint update);
* EMA: 2e-5.

The outer step is held on its losses, both networks' ``u0``, G's running
averages and the EMA.  Gradients, Adam slots and parameters are held on
each update from the same state: the critic update from the initial
state, the joint update from JAX's state after the critic update.  Adam's
first step moves a weight by about lr times the sign of its gradient, so
a D weight whose critic gradient is float noise ends the critic update
up to 2 lr away from JAX's, and G's gradient through that D then moves
by more than the gradient tolerance: the same conditioning that
``tests/test_torch_accum.py`` and ``tests/test_torch_ddp_step.py``
record.

The critic update runs G in train mode and must leave G's state as it
was: the JAX critic step throws G's new collections away, so G's ``u0``
and running averages are the same before and after ``train_d``, with and
without ``grad_accum_steps=2``, and D's gradient is JAX's (with
accumulation each microbatch normalizes G's kernels from the same
``u0``).

The joint update writes G's ``u0`` once a microbatch (1e-7: the same
float32 power steps on the same kernels).

G alone at 64 px (width 16), in the reference layout without scale
fusion and the spectral one with the dilated up-convs, in train and eval
mode, as ``tests/test_torch_reference_layout.py`` holds it at 32 px:
images and new state within 1e-4 relative and 1e-5 absolute.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.engine import create_train_state as j_state
from xmcgan_image_generation_tpu.engine import xmc_gan as j_xmc_gan
from xmcgan_image_generation_tpu.engine.step import split_batch as j_split
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.data import synthetic
from xmcgan_image_generation_tpu_torch.engine import xmc_gan
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.engine.step import split_batch
from xmcgan_image_generation_tpu_torch.engine.step import train_step
from xmcgan_image_generation_tpu_torch.ops.spectral_norm import (
    power_iteration_normalize,
)
from xmcgan_image_generation_tpu_torch.utils import bridge

import test_torch_reference_layout as layout

torch.set_num_threads(1)

OVERRIDES = dict(dtype="float32", scale_fused_convs=True,
                 upconv_method="dilated", g_spectral_norm=True)
LOSSES = ("d_loss", "g_loss", "c_loss_d", "c_loss_g", "c_loss_g_pretrained")


def _configs(**extra):
  j_config = j_coco_xmc.get_test_config()
  config = coco_xmc.get_test_config()
  for k, v in {**OVERRIDES, **extra}.items():
    setattr(j_config, k, v)
    setattr(config, k, v)
  return j_config, config


def _flat(tree):
  return {k: np.asarray(v, np.float32)
          for k, v in bridge.flatten(jax.device_get(tree)).items()}


@pytest.fixture(scope="module")
def initial():
  """The JAX initial state, shared by both sides."""
  j_config, config = _configs()
  super_batch = synthetic.super_batch(config, np.random.default_rng(0))
  init_batch = j_split(super_batch, j_config.d_step_per_g_step)[0]
  gen, disc, state = j_state(j_config, jax.random.PRNGKey(0), init_batch)
  assert "spectral_norm_stats" in state.generator_state
  return dict(gen=gen, disc=disc, state=state, batch=super_batch)


def _port_state(initial, config):
  s0 = jax.device_get(initial["state"])
  state = create_train_state(config, "cpu", seed=0)
  assert not state.generator.fused
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
  return state


def _jit(update, initial, config, **kw):
  return jax.jit(functools.partial(
      update, generator=initial["gen"], discriminator=initial["disc"],
      config=config, **kw))


def _results(state, metrics=None):
  """What the tests compare, from a JAX state."""
  new = jax.device_get(state)
  out = dict(
      g_params=_flat(new.g_params), d_params=_flat(new.d_params),
      g_mu=_flat(new.g_opt_state[0].mu), g_nu=_flat(new.g_opt_state[0].nu),
      d_mu=_flat(new.d_opt_state[0].mu), d_nu=_flat(new.d_opt_state[0].nu),
      g_count=int(new.g_opt_state[0].count),
      d_count=int(new.d_opt_state[0].count),
      batch_stats=_flat(new.generator_state["batch_stats"]),
      g_u0=_flat(new.generator_state["spectral_norm_stats"]),
      d_u0=_flat(new.discriminator_state["spectral_norm_stats"]),
      ema=_flat(new.ema_params))
  if metrics is not None:
    out["losses"] = {k: float(v) for k, v in metrics.items()}
  return out


@pytest.fixture(scope="module")
def jax_run(initial):
  """JAX's critic update from the initial state, then its joint update."""
  j_config, _ = _configs()
  subs = j_split(initial["batch"], j_config.d_step_per_g_step)
  after_critic = _jit(j_xmc_gan.train_d, initial, j_config)(
      jax.random.PRNGKey(1), initial["state"], subs[0])
  new, metrics = _jit(j_xmc_gan.train_g_d, initial, j_config,
                      additional_data={})(
                          jax.random.PRNGKey(2), after_critic, subs[1])
  return dict(after_critic=after_critic,
              critic=_results(after_critic),
              outer=_results(new, metrics))


def _port_results(state, metrics):
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
      g_u0=_flat(g_vars["spectral_norm_stats"]),
      d_u0=_flat(d_vars["spectral_norm_stats"]),
      ema=_flat(bridge.tensors_to_jax(state.ema_params)), step=state.step)


@pytest.fixture(scope="module")
def port_outer(initial):
  """The port's outer step (``train_step``) from the initial state."""
  _, config = _configs()
  state = _port_state(initial, config)
  state, metrics = train_step(state, bridge.to_tensors(initial["batch"]),
                              config, {})
  return _port_results(state, metrics)


@pytest.fixture(scope="module")
def port_joint(initial, jax_run):
  """The port's joint update from JAX's state after the critic update."""
  _, config = _configs()
  state = _port_state(dict(initial, state=jax_run["after_critic"]), config)
  state.step = 1
  sub = split_batch(bridge.to_tensors(initial["batch"]),
                    config.d_step_per_g_step)[1]
  metrics = xmc_gan.train_g_d(state, sub, config)
  return _port_results(state, metrics)


def _close_trees(got, want, rtol, atol=0.0, scaled=0.0, floor=0.0):
  """``floor`` is a fraction of the largest magnitude in the whole tree."""
  assert set(got) == set(want)
  top = max(float(np.abs(v).max()) for v in want.values())
  for name in want:
    tol = max(atol + scaled * float(np.abs(want[name]).max()), floor * top)
    np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=tol,
                               err_msg=name)


@pytest.mark.parametrize("run", ["outer", "joint"])
def test_losses(port_outer, port_joint, jax_run, run):
  got = (port_outer if run == "outer" else port_joint)
  assert got["step"] == {"outer": 1, "joint": 2}[run]
  want = jax_run["outer"]["losses"]
  assert set(got["losses"]) == set(LOSSES) == set(want)
  for k in LOSSES:
    np.testing.assert_allclose(got["losses"][k], want[k], rtol=1e-4,
                               atol=1e-5, err_msg=k)


def test_generator_gradients(port_joint, jax_run):
  """After one Adam step from zero slots, mu = (1 - beta1) g."""
  beta1 = coco_xmc.get_config().beta1
  got = {k: v / (1 - beta1) for k, v in port_joint["g_mu"].items()}
  want = {k: v / (1 - beta1) for k, v in jax_run["outer"]["g_mu"].items()}
  assert any(k.startswith("GenSpatialBlock_") for k in want)
  _close_trees(got, want, rtol=1e-3, scaled=1e-3, floor=1e-5)


@pytest.mark.parametrize("slot", ["g_mu", "g_nu", "d_mu", "d_nu"])
def test_adam_slots(port_joint, jax_run, slot):
  floor = 1e-10 if slot.endswith("nu") else 1e-5
  _close_trees(port_joint[slot], jax_run["outer"][slot], rtol=1e-3,
               scaled=1e-3, floor=floor)


@pytest.mark.parametrize("run", ["outer", "joint"])
def test_adam_counts(port_outer, port_joint, jax_run, run):
  got = port_outer if run == "outer" else port_joint
  assert got["g_count"] == jax_run["outer"]["g_count"] == 1
  assert got["d_count"] == jax_run["outer"]["d_count"] == 2


@pytest.mark.parametrize("net,lr", [("g", 1e-4), ("d", 4e-4)])
def test_params(port_joint, jax_run, net, lr):
  _close_trees(port_joint[f"{net}_params"],
               jax_run["outer"][f"{net}_params"], rtol=0, atol=2 * lr)


@pytest.mark.parametrize("run", ["outer", "joint"])
@pytest.mark.parametrize("net", ["g", "d"])
def test_spectral_norm_u0(port_outer, port_joint, jax_run, initial, net,
                          run):
  """Both networks' ``u0`` after the step; G's moved (by the joint
  update)."""
  got = port_outer if run == "outer" else port_joint
  _close_trees(got[f"{net}_u0"], jax_run["outer"][f"{net}_u0"], rtol=0,
               atol=1e-3)
  start = _flat(initial["state"].generator_state["spectral_norm_stats"])
  if net == "g":
    assert max(float(np.abs(got["g_u0"][k] - v).max())
               for k, v in start.items()) > 1e-3


@pytest.mark.parametrize("run", ["outer", "joint"])
def test_batch_stats(port_outer, port_joint, jax_run, run):
  got = port_outer if run == "outer" else port_joint
  _close_trees(got["batch_stats"], jax_run["outer"]["batch_stats"],
               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("run", ["outer", "joint"])
def test_ema(port_outer, port_joint, jax_run, run):
  got = port_outer if run == "outer" else port_joint
  _close_trees(got["ema"], jax_run["outer"]["ema"], rtol=0, atol=2e-5)


@pytest.mark.parametrize("k", [1, 2], ids=["whole", "grad_accum_2"])
def test_critic_update_keeps_g_state(initial, jax_run, k):
  """``train_d`` leaves G's ``u0`` and running averages as they were, and
  its D gradient is the JAX critic update's."""
  j_config, config = _configs(grad_accum_steps=k)
  if k == 1:
    want_mu = jax_run["critic"]["d_mu"]
  else:
    sub = j_split(initial["batch"], j_config.d_step_per_g_step)[0]
    new = _jit(j_xmc_gan.train_d, initial, j_config)(
        jax.random.PRNGKey(1), initial["state"], sub)
    want_mu = _results(new)["d_mu"]

  state = _port_state(initial, config)
  before = {n: v.clone() for n, v in state.generator.state_dict().items()
            if n.endswith(("u0", "mean", "var"))}
  assert sum(n.endswith("u0") for n in before) > 20
  xmc_gan.train_d(state, split_batch(bridge.to_tensors(initial["batch"]),
                                     config.d_step_per_g_step)[0], config)
  after = state.generator.state_dict()
  for name, value in before.items():
    torch.testing.assert_close(after[name], value, rtol=0, atol=0,
                               msg=name)
  mu, _, count = bridge.adam_state_to_jax(state.d_opt, state.discriminator)
  assert count == 1
  beta1 = config.beta1
  _close_trees({n: v / (1 - beta1) for n, v in _flat(mu).items()},
               {n: v / (1 - beta1) for n, v in want_mu.items()},
               rtol=1e-3, scaled=1e-3, floor=1e-5)


@pytest.mark.parametrize("k", [1, 2], ids=["whole", "grad_accum_2"])
def test_joint_update_advances_g_u0_once_a_microbatch(initial, k):
  """The joint update writes G's ``u0`` once a (micro)batch, as JAX's
  ``mutable`` collections thread through its microbatches: the kernels
  change only after the last, so ``u0`` ends k power steps from where it
  started."""
  _, config = _configs(grad_accum_steps=k)
  state = _port_state(initial, config)
  layers = {n: m for n, m in state.generator.named_modules()
            if getattr(m, "spectral", False)}
  want = {}
  with torch.no_grad():
    for name, m in layers.items():
      u0 = m.u0.clone()
      for _ in range(k):
        _, u0 = power_iteration_normalize(m._kernel_2d(m.kernel), u0)
      want[name] = u0
  xmc_gan.train_g_d(state, split_batch(bridge.to_tensors(initial["batch"]),
                                       config.d_step_per_g_step)[1], config)
  for name, m in layers.items():
    torch.testing.assert_close(m.u0, want[name], rtol=0, atol=1e-7,
                               msg=name)


@pytest.fixture(scope="module", params=[
    ("reference", "unfused"), ("spectral", "dilated")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def generator64(request):
  return layout._jax_generator(*request.param, 64)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_generator_64px(generator64, train):
  layout._generator_case(generator64, train)

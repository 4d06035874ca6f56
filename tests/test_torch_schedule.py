"""The port's learning-rate schedules and epoch-derived step count against
the JAX package's, on the CPU.

Schedules: the values of JAX ``learning_rates`` (optax, float32) at the
boundary steps of warmup and decay, for G and for the stretched D
schedule, within float32 rounding: 1e-6 relative, and 1e-6 of the peak
rate absolute (near the end of a cosine decay optax's float32
``1 + cos`` cancels to a few ulps of the peak); the same validation
errors.  Three Adam updates under ``cosine`` against
``optax.adam(schedule)``: 1e-6 relative and 1e-9 absolute (float32
arithmetic in other orders).  Then scheduled, epoch-derived training on
the CPU logs the JAX values and resumes mid-schedule exactly.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.engine.state import (
    learning_rates as j_learning_rates,
)
from xmcgan_image_generation_tpu.train import (
    compute_num_train_steps as j_num_steps,
)
from xmcgan_image_generation_tpu_torch import train as train_lib
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.engine.state import (
    ScheduledAdam,
    learning_rates,
)
from xmcgan_image_generation_tpu_torch.utils import checkpoint

torch.set_num_threads(1)


def _configs(**overrides):
  j_config, config = j_coco_xmc.get_test_config(), coco_xmc.get_test_config()
  for c in (j_config, config):
    for k, v in overrides.items():
      setattr(c, k, v)
  return j_config, config


@pytest.mark.parametrize("schedule,warmup,decay", [
    ("cosine", 10, 100), ("cosine", 0, 7), ("linear", 10, 110),
    ("linear", 0, 9)])
def test_schedule_values_match_jax(schedule, warmup, decay):
  j_config, config = _configs(lr_schedule=schedule, lr_warmup_steps=warmup,
                              lr_decay_steps=decay, d_step_per_g_step=2)
  for got, want, stretch, peak in zip(learning_rates(config),
                                      j_learning_rates(j_config), (1, 2),
                                      (config.g_lr, config.d_lr)):
    assert callable(got) and callable(want)
    w, d = warmup * stretch, decay * stretch
    steps = sorted({0, 1, max(w - 1, 0), w, w + 1, (w + d) // 2, d - 1, d,
                    d + 1, 3 * d})
    for step in steps:
      np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                 atol=1e-6 * peak, err_msg=f"step {step}")


def test_constant_rates_are_floats():
  j_config, config = _configs()
  assert learning_rates(config) == j_learning_rates(j_config) == (
      config.g_lr, config.d_lr)


@pytest.mark.parametrize("overrides,message", [
    (dict(lr_schedule="cosine", lr_decay_steps=0), "lr_decay_steps > 0"),
    (dict(lr_schedule="linear", lr_warmup_steps=5, lr_decay_steps=5),
     r"lr_warmup_steps \(5\) must be < lr_decay_steps \(5\)"),
    (dict(lr_schedule="step", lr_decay_steps=5), "Unknown lr_schedule")])
def test_validation_matches_jax(overrides, message):
  j_config, config = _configs(**overrides)
  for fn, c in ((learning_rates, config), (j_learning_rates, j_config)):
    with pytest.raises(ValueError, match=message):
      fn(c)


def test_three_adam_updates_under_cosine_match_optax():
  """The first update takes the schedule's value at count 0 (0 during a
  warmup from 0), then 1, then 2."""
  _, config = _configs(lr_schedule="cosine", lr_warmup_steps=2,
                       lr_decay_steps=6)
  j_config, _ = _configs(lr_schedule="cosine", lr_warmup_steps=2,
                         lr_decay_steps=6)
  rng = np.random.default_rng(0)
  w0 = rng.standard_normal((4, 3)).astype(np.float32)
  grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(3)]
  g_sched = j_learning_rates(j_config)[0]
  tx = optax.adam(g_sched, b1=0.5, b2=0.999)
  params = jnp.asarray(w0)
  opt_state = tx.init(params)
  p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
  opt = ScheduledAdam([p], schedule=learning_rates(config)[0],
                      betas=(0.5, 0.999), eps=1e-8)
  for g in grads:
    updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
    params = optax.apply_updates(params, updates)
    p.grad = torch.from_numpy(g)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                               rtol=1e-6, atol=1e-9)
  assert opt.param_groups[0]["lr_count"] == 3
  np.testing.assert_allclose(opt.param_groups[0]["lr"], float(g_sched(2)),
                             rtol=1e-6)
  # The first update moved nothing: lr 0 at count 0.
  assert float(g_sched(0)) == 0.0


@pytest.mark.parametrize("steps,examples", [(-1, 64), (-1, 3), (5, 64)])
def test_epoch_derived_step_count_matches_jax(steps, examples):
  j_config, config = _configs(num_train_steps=steps, num_epochs=3)
  assert (train_lib.compute_num_train_steps(config, examples)
          == j_num_steps(j_config, examples))


def _metrics(workdir):
  with open(os.path.join(workdir, "metrics.jsonl")) as f:
    return [json.loads(line) for line in f]


def test_scheduled_epoch_run_logs_jax_rates_and_resumes(tmp_path):
  """``num_train_steps=-1`` over the synthetic source's 64 examples, 4 a
  step, one epoch: 16 steps under ``linear``, logging the JAX rates; a
  run stopped at step 9 and resumed takes the same steps 10-16."""
  overrides = dict(num_train_steps=-1, num_epochs=1, lr_schedule="linear",
                   lr_warmup_steps=3, lr_decay_steps=20,
                   checkpoint_every_steps=9, eval_every_steps=100)
  j_config, config = _configs(**overrides)
  whole = str(tmp_path / "whole")
  state = train_lib.train(config, whole, "cpu")
  assert state.step == 16
  j_g, j_d = j_learning_rates(j_config)
  lines = _metrics(whole)
  assert [m["step"] for m in lines] == list(range(1, 17))
  for m in lines:
    np.testing.assert_allclose(m["g_lr"], float(j_g(m["step"])), rtol=1e-6,
                               atol=1e-6 * config.g_lr)
    np.testing.assert_allclose(m["d_lr"], float(j_d(2 * m["step"])),
                               rtol=1e-6, atol=1e-6 * config.d_lr)
  # The optimizers' counts: one G update and two D updates a step.
  assert state.g_opt.param_groups[0]["lr_count"] == 16
  assert state.d_opt.param_groups[0]["lr_count"] == 32

  parts = str(tmp_path / "parts")
  _, short = _configs(**{**overrides, "num_train_steps": 9})
  train_lib.train(short, parts, "cpu")
  manager = checkpoint.CheckpointManager(checkpoint.checkpoints_dir(parts))
  assert manager.all_steps() == [9]
  resumed = train_lib.train(config, parts, "cpu")
  assert resumed.g_opt.param_groups[0]["lr_count"] == 16
  losses = [{k: v for k, v in m.items() if "seconds" not in k}
            for m in _metrics(parts)]
  assert losses == [{k: v for k, v in m.items() if "seconds" not in k}
                    for m in lines]

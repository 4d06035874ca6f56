"""Faults planted under the timed path, to show that the comparison fails
them (`calibrate`, ``tests/test_correct_controls.py``).  Each wraps a
function of the port; nothing here runs in a benchmark run."""

from __future__ import annotations

import copy

import torch


def unchanged_state(real):
  """A training step that computes its losses and leaves the state as it
  was."""

  def step(state, batch, config, additional):
    nets = (state.generator, state.discriminator)
    opts = (state.g_opt, state.d_opt)
    saved = [copy.deepcopy(m.state_dict()) for m in nets]
    saved_opts = [copy.deepcopy(o.state_dict()) for o in opts]
    ema = {k: v.clone() for k, v in state.ema_params.items()}
    out = real(state, batch, config, additional)
    for m, s in zip(nets, saved):
      m.load_state_dict(s)
    for o, s in zip(opts, saved_opts):
      o.load_state_dict(s)
    for k, v in ema.items():
      state.ema_params[k].copy_(v)
    return out

  return step


def half_batch(real):
  """A training step that drops the second half of each sub-batch and
  takes its means over the rest."""

  def step(state, batch, config, additional):
    from xmcgan_image_generation_tpu_torch.engine.step import split_batch

    subs = split_batch(batch, config.d_step_per_g_step)
    kept = {k: torch.cat([s[k][:s[k].shape[0] // 2] for s in subs])
            for k in batch}
    return real(state, kept, config, additional)

  return step


def altered_image(real_load, call: int = 5):
  """``load_exported`` whose program halves the image of its ``call``-th
  request."""

  def load(*args, **kwargs):
    module = real_load(*args, **kwargs).module()
    calls = []

    def serve(*inputs):
      calls.append(None)
      image = module(*inputs)
      return image * 0.5 if len(calls) == call else image

    return type("Program", (), {"module": lambda self: serve})()

  return load


TRAINING = {"unchanged": unchanged_state, "half": half_batch}

"""The port's checkpoints and resume, on the CPU at the test config.

A checkpoint holds the whole train state and the data loader's position:
a round trip restores every tensor and the loader exactly, and a run that
stops after step 1 and resumes from its checkpoint takes a step 2 that is
bit-identical to an uninterrupted run's (PyTorch's CPU kernels are
deterministic for a fixed thread count).
"""

import json
import os

import pytest
import torch

from xmcgan_image_generation_tpu_torch import train as train_lib
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.utils import checkpoint
from xmcgan_image_generation_tpu_torch.utils import task_manager

torch.set_num_threads(1)


def _config(steps):
  config = coco_xmc.get_test_config()
  config.num_train_steps = steps
  return config


def _tensors(state):
  """Every tensor of the state, by a name that says where it lives."""
  out = {f"g.{k}": v for k, v in state.generator.state_dict().items()}
  out.update({f"d.{k}": v
              for k, v in state.discriminator.state_dict().items()})
  out.update({f"ema.{k}": v for k, v in state.ema_params.items()})
  for net, opt in (("g", state.g_opt), ("d", state.d_opt)):
    for i, slots in opt.state_dict()["state"].items():
      out.update({f"{net}_opt.{i}.{k}": v for k, v in slots.items()})
  return out


def _assert_same_state(got, want):
  assert got.step == want.step
  a, b = _tensors(got), _tensors(want)
  assert set(a) == set(b)
  for name in b:
    torch.testing.assert_close(a[name], b[name], rtol=0, atol=0,
                               msg=name)


def _losses(workdir):
  with open(os.path.join(workdir, "metrics.jsonl")) as f:
    return [{k: v for k, v in json.loads(line).items()
             if "seconds" not in k} for line in f]


def test_round_trip_is_exact(tmp_path):
  """One trained step (so the Adam slots are filled), saved, restored into
  a state built from another seed, and the loader's position with it."""
  config = _config(1)
  run, _ = train_lib.setup(config, torch.device("cpu"))
  train_lib.timed_step(run, config, torch.device("cpu"))
  state, _, stream = run
  manager = checkpoint.CheckpointManager(str(tmp_path))
  seconds, size = manager.save(1, state, stream)
  assert seconds >= 0 and size == os.path.getsize(manager.path(1))
  following = next(stream)
  stream.close()

  fresh = create_train_state(config, "cpu", seed=config.seed + 7)
  (_, _, fresh_stream), _ = train_lib.setup(config, torch.device("cpu"))
  assert manager.restore_or_initialize(fresh, fresh_stream) is fresh
  _assert_same_state(fresh, state)
  assert fresh_stream.get_state()["position"] == 1
  got = next(fresh_stream)
  fresh_stream.close()
  assert set(got) == set(following)
  for key, value in got.items():
    torch.testing.assert_close(value, following[key], rtol=0, atol=0,
                               msg=key)


def test_resume_is_bit_identical(tmp_path):
  """1 step, checkpoint, a fresh process state restored from it, 1 more
  step: the same losses and state as 2 uninterrupted steps."""
  whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
  want = train_lib.train(_config(2), whole, "cpu")
  train_lib.train(_config(1), parts, "cpu")
  assert checkpoint.list_steps(checkpoint.checkpoints_dir(parts)) == [1]
  got = train_lib.train(_config(2), parts, "cpu")
  _assert_same_state(got, want)
  assert _losses(parts) == _losses(whole)
  assert [r["step"] for r in _losses(parts)] == [1, 2]
  assert task_manager.TaskManager(
      checkpoint.checkpoints_dir(parts)).is_training_done()


def test_max_to_keep(tmp_path):
  config = _config(1)
  (state, _, stream), _ = train_lib.setup(config, torch.device("cpu"))
  manager = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
  assert manager.latest_step() is None
  for step in (1, 2, 3, 5):
    state.step = step
    manager.save(step, state, stream)
  assert manager.all_steps() == [3, 5]
  assert sorted(os.listdir(tmp_path)) == ["checkpoint_3.pt",
                                          "checkpoint_5.pt"]
  assert manager.latest_step() == 5


def test_stream_rejects_another_seed():
  """The loader's position is tied to its loader: a loader of another seed
  refuses it."""
  config = _config(1)
  (_, _, stream), _ = train_lib.setup(config, torch.device("cpu"))
  next(stream)
  state = stream.get_state()
  stream.close()
  config.seed += 1
  (_, _, other), _ = train_lib.setup(config, torch.device("cpu"))
  with pytest.raises(ValueError, match="seed"):
    other.set_state(state)

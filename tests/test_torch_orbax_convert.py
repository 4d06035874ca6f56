"""A checkpoint of the JAX package (Orbax, with grain's iterator state)
carried into the port by ``tools/orbax_to_torch.py``, on the CPU.

JAX trains the 32 px test config for two outer steps on seeded COCO-schema
records (``tests/test_torch_data.py``'s image helper) through its
engine's jitted step, as ``tests/test_torch_step.py`` does, saves the
state and the grain iterator with its own ``CheckpointManager``, and
takes step 3.  The converter writes the port's checkpoint; the port
restores it, its loader yields JAX's batch of step 3 exactly, and its
step 3 equals JAX's within ``tests/test_torch_step.py``'s tolerances
(float32 both sides, one step from the same state):

* losses, batch statistics: 1e-4 relative;
* Adam slots: 1e-3 relative plus 1e-3 of the tensor's largest magnitude,
  at least 1e-5 (``mu``) or 1e-10 (``nu``) of the network's largest;
* parameters: 2 lr per Adam step of this outer step (G 1 at 1e-4, D 2
  at 4e-4);
* ``u0``: 1e-3; EMA: 2e-5.

A tree with a renamed key and a grain state of another worker count
raise, and the grain arithmetic is held against live grain loaders with
0 and 2 workers, one process and process 1 of 2.
"""

import dataclasses
import functools
import json

import grain.python as pg
import jax
import numpy as np
import pytest
import torch

from test_torch_data import _pillow_png, _smooth
from tools import orbax_to_torch
from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.data import pipeline as j_pipeline
from xmcgan_image_generation_tpu.engine import create_train_state as j_state
from xmcgan_image_generation_tpu.engine.step import split_batch as j_split
from xmcgan_image_generation_tpu.engine.step import train_step as j_step
from xmcgan_image_generation_tpu.utils import checkpoint as j_checkpoint
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.data import pipeline
from xmcgan_image_generation_tpu_torch.data import records
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.engine.step import train_step
from xmcgan_image_generation_tpu_torch.utils import bridge
from xmcgan_image_generation_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

OVERRIDES = dict(dtype="float32", scale_fused_convs=True,
                 upconv_method="dilated", data_source="tfrecord")
LOSSES = ("d_loss", "g_loss", "c_loss_d", "c_loss_g", "c_loss_g_pretrained")


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
  """Both test configs over 8 train shards of 3 records and a validation
  shard."""
  root = tmp_path_factory.mktemp("coco")
  rng = np.random.default_rng(11)
  for split, shards, per in (("train", 8, 3), ("validation", 1, 2)):
    for s in range(shards):
      path = root / f"coco2014_{split}.tfrecord-{s:05d}-of-{shards:05d}"
      with records.TFRecordWriter(str(path)) as w:
        for _ in range(per):
          image = _smooth(rng, int(rng.integers(30, 60)),
                          int(rng.integers(30, 60)))
          w.write(records.build_example({
              "image": _pillow_png(image),
              "caption/embedding": rng.standard_normal(
                  5 * 17 * 768).astype(np.float32),
              "caption/max_len": rng.integers(3, 18, (5,)).astype(np.int64),
              "caption/text": [b"a caption"] * 5}))
  j_config, config = j_coco_xmc.get_test_config(), coco_xmc.get_test_config()
  for c in (j_config, config):
    for k, v in dict(OVERRIDES, data_dir=str(root)).items():
      setattr(c, k, v)
  return j_config, config


def _flat(tree):
  return {k: np.asarray(v, np.float32)
          for k, v in bridge.flatten(jax.device_get(tree)).items()}


def _results(state, losses):
  """The quantities the checks compare, from a JAX ``TrainState``."""
  return dict(
      losses={k: float(v) for k, v in losses.items()},
      g_params=_flat(state.g_params), d_params=_flat(state.d_params),
      g_mu=_flat(state.g_opt_state[0].mu), g_nu=_flat(state.g_opt_state[0].nu),
      d_mu=_flat(state.d_opt_state[0].mu), d_nu=_flat(state.d_opt_state[0].nu),
      g_count=int(state.g_opt_state[0].count),
      d_count=int(state.d_opt_state[0].count),
      batch_stats=_flat(state.generator_state["batch_stats"]),
      u0=_flat(state.discriminator_state["spectral_norm_stats"]),
      ema=_flat(state.ema_params), step=int(state.step))


@pytest.fixture(scope="module")
def jax_run(configs, tmp_path_factory):
  """Two JAX steps, the checkpoint of step 2 (state and grain), step 3."""
  j_config, _ = configs
  workdir = str(tmp_path_factory.mktemp("jax"))
  train_loader, _, _ = j_pipeline.create_datasets(j_config,
                                                  seed=j_config.seed)
  it = iter(train_loader)
  template = next(it)   # the JAX loop initializes its models from it
  gen, disc, state = j_state(j_config, jax.random.PRNGKey(0),
                             j_split(template, j_config.d_step_per_g_step)[0])
  step = jax.jit(functools.partial(
      j_step, generator=gen, discriminator=disc, config=j_config,
      additional_data={}))
  key = jax.random.PRNGKey(1)
  for s in (1, 2):
    state, _ = step(jax.random.fold_in(key, s), state, next(it))
  manager = j_checkpoint.CheckpointManager(
      j_checkpoint.checkpoints_dir(workdir))
  manager.save(2, jax.device_get(state), it)
  manager.wait_until_finished()
  manager.close()
  batch = next(it)
  new, metrics = step(jax.random.fold_in(key, 3), state, batch)
  return dict(workdir=workdir, batch=batch,
              result=_results(jax.device_get(new), metrics))


@pytest.fixture(scope="module")
def converted(configs, jax_run, tmp_path_factory):
  """The converter's three stages, then the port's restore and step 3."""
  j_config, config = configs
  step, jax_state, grain = orbax_to_torch.restore_jax(
      j_config, config, jax_run["workdir"])
  state, loaders = orbax_to_torch.to_port(config, step, jax_state, grain)
  out = str(tmp_path_factory.mktemp("port"))
  path = orbax_to_torch.write_port(out, step, state, loaders)

  fresh = create_train_state(config, "cpu", seed=config.seed + 3)
  stream = iter(pipeline.create_datasets(config, seed=config.seed)[0])
  manager = checkpoint.CheckpointManager(checkpoint.checkpoints_dir(out))
  manager.restore_or_initialize(fresh, stream)
  batch = next(stream)
  stream.close()
  fresh, metrics = train_step(fresh, bridge.to_tensors(batch), config, {})
  g_mu, g_nu, g_count = bridge.adam_state_to_jax(fresh.g_opt,
                                                 fresh.generator)
  d_mu, d_nu, d_count = bridge.adam_state_to_jax(fresh.d_opt,
                                                 fresh.discriminator)
  g_vars = bridge.jax_from_state_dict(fresh.generator.state_dict())
  d_vars = bridge.jax_from_state_dict(fresh.discriminator.state_dict())
  return dict(
      path=path, steps=manager.all_steps(), batch=batch, loaders=loaders,
      jax_state=jax_state, grain=grain, step=step,
      result=dict(
          losses={k: float(v) for k, v in metrics.items()},
          g_params=_flat(g_vars["params"]), d_params=_flat(d_vars["params"]),
          g_mu=_flat(g_mu), g_nu=_flat(g_nu), d_mu=_flat(d_mu),
          d_nu=_flat(d_nu), g_count=g_count, d_count=d_count,
          batch_stats=_flat(g_vars["batch_stats"]),
          u0=_flat(d_vars["spectral_norm_stats"]),
          ema=_flat(bridge.tensors_to_jax(fresh.ema_params)),
          step=fresh.step))


def _close_trees(got, want, rtol, atol=0.0, scaled=0.0, floor=0.0):
  """``floor`` is a fraction of the largest magnitude in the whole tree."""
  assert set(got) == set(want)
  top = max(float(np.abs(v).max()) for v in want.values())
  for name in want:
    tol = max(atol + scaled * float(np.abs(want[name]).max()), floor * top)
    np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=tol,
                               err_msg=name)


def test_checkpoint_written(converted):
  assert converted["step"] == 2 and converted["steps"] == [2]
  assert converted["path"].endswith("checkpoint_2.pt")
  # The template and two steps' super-batches were consumed.
  assert converted["loaders"][0]["position"] == 3


def test_loader_yields_jax_batch(converted, jax_run):
  got, want = converted["batch"], jax_run["batch"]
  assert set(got) == set(want)
  for key, value in want.items():
    assert got[key].dtype == value.dtype, key
    np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_step3_losses(converted, jax_run):
  got, want = converted["result"], jax_run["result"]
  assert got["step"] == want["step"] == 3
  for k in LOSSES:
    np.testing.assert_allclose(got["losses"][k], want["losses"][k],
                               rtol=1e-4, atol=1e-5, err_msg=k)


def test_step3_adam_counts(converted, jax_run):
  got, want = converted["result"], jax_run["result"]
  assert got["g_count"] == want["g_count"] == 3
  assert got["d_count"] == want["d_count"] == 6


@pytest.mark.parametrize("slot", ["g_mu", "g_nu", "d_mu", "d_nu"])
def test_step3_adam_slots(converted, jax_run, slot):
  floor = 1e-10 if slot.endswith("nu") else 1e-5
  _close_trees(converted["result"][slot], jax_run["result"][slot],
               rtol=1e-3, scaled=1e-3, floor=floor)


@pytest.mark.parametrize("net,lr,steps", [("g", 1e-4, 1), ("d", 4e-4, 2)])
def test_step3_params(converted, jax_run, net, lr, steps):
  _close_trees(converted["result"][f"{net}_params"],
               jax_run["result"][f"{net}_params"], rtol=0,
               atol=2 * lr * steps)


def test_step3_u0_batch_stats_ema(converted, jax_run):
  got, want = converted["result"], jax_run["result"]
  _close_trees(got["u0"], want["u0"], rtol=0, atol=1e-3)
  _close_trees(got["batch_stats"], want["batch_stats"], rtol=1e-4,
               atol=1e-5)
  _close_trees(got["ema"], want["ema"], rtol=0, atol=2e-5)


def test_renamed_key_raises(configs, converted):
  _, config = configs
  jax_state = converted["jax_state"]
  g_params = dict(jax_state.g_params)
  g_params["Conv_9"] = g_params.pop("Conv_0")
  renamed = dataclasses.replace(jax_state, g_params=g_params)
  with pytest.raises(ValueError, match="missing 'Conv_0.bias', first extra "
                                       "'Conv_9.bias'"):
    orbax_to_torch.to_port(config, converted["step"], renamed,
                           converted["grain"])


def test_other_worker_count_raises(configs, converted):
  _, config = configs
  grain = {0: dict(converted["grain"][0], worker_count=2,
                   last_seen_indices={"0": 10, "1": 7})}
  with pytest.raises(ValueError, match="grain_worker_count=2"):
    orbax_to_torch.to_port(config, converted["step"],
                           converted["jax_state"], grain)


def test_two_processes_write_loader_files(configs, converted, tmp_path):
  """A checkpoint of two JAX processes at the same position: one loader
  file a process (its shard's loader), then the state without one."""
  _, config = configs
  grain = {r: dict(converted["grain"][0],
                   last_seen_indices={"0": r - 2 + 2 * 6})   # 3 batches of 2
           for r in range(2)}
  state, loaders = orbax_to_torch.to_port(config, converted["step"],
                                          converted["jax_state"], grain)
  assert [loaders[r]["position"] for r in range(2)] == [3, 3]
  assert loaders[0]["loader"] != loaders[1]["loader"]
  path = orbax_to_torch.write_port(str(tmp_path), converted["step"], state,
                                   loaders)
  manager = checkpoint.CheckpointManager(checkpoint.checkpoints_dir(
      str(tmp_path)))
  for r in range(2):
    assert checkpoint.load(manager.loader_path(2, r, 2)) == loaders[r]
  payload = checkpoint.load(path)
  assert payload["data_iter"] is None and payload["step"] == 2


@pytest.mark.parametrize("workers,world,rank", [
    (0, 1, 0), (0, 2, 1), (2, 1, 0), (2, 2, 1)])
def test_grain_position_matches_grain(workers, world, rank):
  """The batches a live grain loader has given, from its state."""
  batch = 3
  loader = pg.DataLoader(
      data_source=list(range(48)),
      sampler=pg.IndexSampler(
          num_records=48, shuffle=True, num_epochs=None, seed=5,
          shard_options=pg.ShardOptions(shard_index=rank, shard_count=world,
                                        drop_remainder=True)),
      operations=[pg.Batch(batch, drop_remainder=True)],
      worker_count=workers)
  it = iter(loader)
  for taken in range(5):
    state = json.loads(it.get_state())
    assert orbax_to_torch.grain_position(state, rank, world, batch,
                                         workers) == taken
    next(it)

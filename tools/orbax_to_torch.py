"""Converts a checkpoint of the JAX package into a checkpoint of the
PyTorch port, so that a run trained on the TPU resumes, scores or serves
on the GPU.

The JAX package writes an Orbax OCDBT store per step
(``{workdir}/checkpoints/{step}/state``) and grain's iterator state, one
JSON file per process (``.../{step}/data_iter/process_{r}-of-{W}.json``).
This script:

1. builds the JAX template with the JAX package's
   ``engine.create_train_state`` and restores step N (the latest by
   default) with its ``utils.checkpoint.CheckpointManager``;
2. loads G, D (``batch_stats`` and both ``spectral_norm_stats``), the EMA,
   both optax Adam states and the step into the port's ``TrainState``
   through ``utils/bridge.py``; a tree that does not match the port's
   names raises, naming the first missing and the first extra key;
3. turns each process's grain state into the port's loader state
   (``{"position", "loader"}``): the batches the process has consumed,
   counted from grain's last seen record indices.  grain's batch order
   depends on its worker count and the port follows it, so a state of
   another ``grain_worker_count`` than the configuration's raises;
4. writes the port's checkpoint into ``{out_workdir}/checkpoints`` with
   the port's ``utils/checkpoint.py``: for W processes one
   ``checkpoint_N.loader_R-of-W.pt`` per process first, then
   ``checkpoint_N.pt``.  ``--out_workdir`` may be ``gs://...`` (the
   port's fileio seam), and ``--workdir`` too (Orbax reads it).

It needs JAX, orbax and tensorstore; the machine that then runs the port
needs only the ``.pt`` files.  Neither package imports this script.

    python tools/orbax_to_torch.py --workdir=JAX_WORKDIR \\
        --out_workdir=PORT_WORKDIR [--config=coco_xmc[:test]] [--step=N] \\
        [--config.KEY=VALUE ...]

``--config`` names a configuration module that both packages have
(``coco_xmc``, ``coco_xmc_256``) and its variant; ``--config.KEY=VALUE``
sets a key in both, as the JAX run set it.  For a ``tfrecord`` source the
port's loader is built over ``data_dir`` as the port's run will build it.
"""

from __future__ import annotations

import argparse
import ast
import importlib
import json
import re
import types
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np

_GRAIN_FILE = re.compile(r"^process_(\d+)-of-(\d+)\.json$")


def load_configs(spec: str, overrides: Iterable[str] = ()):
  """``(jax_config, port_config)`` of ``NAME[:VARIANT]`` with each
  ``--config.KEY=VALUE`` of ``overrides`` set in both."""
  name, _, variant = spec.partition(":")
  configs = [importlib.import_module(f"{package}.configs.{name}")
             .get_config(variant)
             for package in ("xmcgan_image_generation_tpu",
                             "xmcgan_image_generation_tpu_torch")]
  for item in overrides:
    key, sep, value = item.partition("=")
    if not (key.startswith("--config.") and sep):
      raise ValueError(f"unrecognized argument {item!r}")
    key = key[len("--config."):]
    try:
      value = ast.literal_eval(value)
    except (ValueError, SyntaxError):
      pass
    for config in configs:
      if key not in config:
        raise ValueError(f"the configuration has no key {key!r}")
      config[key] = value
  return tuple(configs)


def restore_jax(j_config, config, workdir: str, step: Optional[int] = None
                ) -> Tuple[int, Any, Dict[int, Dict[str, Any]]]:
  """``(step, state, grain)``: the JAX ``TrainState`` of ``step`` (the
  latest by default) as numpy, and each process's grain state by rank."""
  import jax

  from xmcgan_image_generation_tpu.engine import create_train_state
  from xmcgan_image_generation_tpu.engine.step import split_batch
  from xmcgan_image_generation_tpu.utils import checkpoint as j_checkpoint
  from xmcgan_image_generation_tpu.utils import fileio as j_fileio
  from xmcgan_image_generation_tpu_torch.data import synthetic

  ckpt_dir = j_checkpoint.checkpoints_dir(workdir)
  manager = j_checkpoint.CheckpointManager(ckpt_dir, with_data_iter=False)
  try:
    step = manager.latest_step() if step is None else step
    if step is None:
      raise FileNotFoundError(f"No JAX checkpoints in {ckpt_dir}")
    # Only the shapes of the template batch matter.
    init_batch = split_batch(
        synthetic.super_batch(config, np.random.default_rng(0)),
        j_config.d_step_per_g_step)[0]
    _, _, template = create_train_state(
        j_config, jax.random.PRNGKey(j_config.seed), init_batch)
    state = jax.device_get(manager.restore(step, template))
  finally:
    manager.close()
  data_dir = j_fileio.join(ckpt_dir, str(step), "data_iter")
  grain = {}
  for name in (j_fileio.listdir(data_dir) if j_fileio.isdir(data_dir)
               else []):
    match = _GRAIN_FILE.match(name)
    if match:
      grain[int(match.group(1))] = (
          json.loads(j_fileio.read_text(j_fileio.join(data_dir, name))),
          int(match.group(2)))
  worlds = {world for _, world in grain.values()}
  if grain and (len(worlds) != 1
                or sorted(grain) != list(range(worlds.pop()))):
    raise ValueError(f"{data_dir}: grain states of processes "
                     f"{sorted(grain)} do not form one run")
  return step, state, {r: s for r, (s, _) in grain.items()}


def grain_position(grain_state: Mapping[str, Any], rank: int, world: int,
                   host_batch: int, worker_count: int) -> int:
  """The number of host batches that process ``rank`` of ``world`` has
  consumed, from its grain state (grain's own ``set_state`` arithmetic:
  worker ``w`` of ``W`` reads the records ``rank + w * world + k * W *
  world`` of the sampler, and batches come from the workers in turn)."""
  if int(grain_state["worker_count"]) != worker_count:
    raise ValueError(
        f"the grain state was written with grain_worker_count="
        f"{grain_state['worker_count']}, the configuration has "
        f"{worker_count}: the port resumes only with the same count, "
        f"since grain's batch order depends on it")
  seen = grain_state["last_seen_indices"]
  workers = max(worker_count, 1)
  stride = workers * world
  records = [(int(seen[str(w)]) + stride - rank - w * world) // stride
             for w in range(workers)]
  position, extra = divmod(sum(records), host_batch)
  expected = [len(range(w, position, workers)) * host_batch
              for w in range(workers)]
  if extra or records != expected:
    raise ValueError(f"grain state {dict(seen)} is not {position} whole "
                     f"batches of {host_batch} over {workers} workers")
  return position


def _check_names(what: str, got: Iterable[str], want: Iterable[str]) -> None:
  got, want = set(got), set(want)
  missing, extra = sorted(want - got), sorted(got - want)
  if missing or extra:
    raise ValueError(
        f"{what}: the checkpoint's tree does not match the port's "
        f"parameters: first missing {missing[0] if missing else None!r}, "
        f"first extra {extra[0] if extra else None!r} "
        f"({len(missing)} missing, {len(extra)} extra)")


def to_port(config, step: int, jax_state, grain: Mapping[int, Mapping],
            device="cpu"):
  """The port's ``TrainState`` holding ``jax_state``, and each process's
  loader state by rank (none without grain states)."""
  import torch

  from xmcgan_image_generation_tpu_torch.data import pipeline
  from xmcgan_image_generation_tpu_torch.engine.state import (
      create_train_state,
  )
  from xmcgan_image_generation_tpu_torch.utils import bridge

  state = create_train_state(config, device, seed=config.seed)
  for what, module, params, collections in (
      ("generator", state.generator, jax_state.g_params,
       jax_state.generator_state),
      ("discriminator", state.discriminator, jax_state.d_params,
       jax_state.discriminator_state)):
    variables = {"params": params, **collections}
    _check_names(what, bridge.state_dict_from_jax(variables),
                 module.state_dict())
    bridge.load_jax_variables(module, variables)   # and the shapes
  for what, opt, module, opt_state in (
      ("g_opt_state", state.g_opt, state.generator, jax_state.g_opt_state),
      ("d_opt_state", state.d_opt, state.discriminator,
       jax_state.d_opt_state)):
    adam = opt_state[0]
    names = dict(module.named_parameters())
    for slot in (adam.mu, adam.nu):
      _check_names(what, bridge.tree_to_torch(slot), names)
    bridge.load_adam_state(opt, module, adam.mu, adam.nu, int(adam.count))
  ema = bridge.tree_to_torch(jax_state.ema_params)
  _check_names("ema_params", ema, state.ema_params)
  with torch.no_grad():
    for name, value in ema.items():
      state.ema_params[name].copy_(value)
  if int(jax_state.step) != step:
    raise ValueError(f"checkpoint {step} holds step {int(jax_state.step)}")
  state.step = step
  world = len(grain)
  loaders = {}
  for rank, grain_state in grain.items():
    loader, _, _ = pipeline.create_datasets(
        config, seed=config.seed, process_index=rank, process_count=world)
    host_batch = (config.batch_size // world) * config.d_step_per_g_step
    loaders[rank] = {
        "position": grain_position(grain_state, rank, world, host_batch,
                                   config.get("grain_worker_count", 0)),
        "loader": repr(loader)}
  return state, loaders


def write_port(out_workdir: str, step: int, state, loaders) -> str:
  """Writes the port's checkpoint of ``step``; returns its path."""
  from xmcgan_image_generation_tpu_torch.utils import checkpoint
  from xmcgan_image_generation_tpu_torch.utils import fileio

  manager = checkpoint.CheckpointManager(
      checkpoint.checkpoints_dir(out_workdir))
  if len(loaders) > 1:
    fileio.makedirs(manager.directory)
    for rank, loader in loaders.items():
      checkpoint.write(loader, manager.loader_path(step, rank, len(loaders)))
    manager.save(step, state)
  else:
    # `save` takes the stream whose state it stores.
    stream = (types.SimpleNamespace(get_state=lambda: loaders[0])
              if loaders else None)
    manager.save(step, state, stream)
  return manager.path(step)


def convert(j_config, config, workdir: str, out_workdir: str,
            step: Optional[int] = None) -> str:
  """`restore_jax`, `to_port` and `write_port`; returns the path of the
  port's checkpoint."""
  step, jax_state, grain = restore_jax(j_config, config, workdir, step)
  state, loaders = to_port(config, step, jax_state, grain)
  return write_port(out_workdir, step, state, loaders)


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--workdir", required=True,
                      help="the JAX package's training workdir")
  parser.add_argument("--out_workdir", required=True,
                      help="the port's workdir to write")
  parser.add_argument("--config", default="coco_xmc",
                      help="NAME[:VARIANT] of both packages' configs")
  parser.add_argument("--step", type=int, default=None)
  args, overrides = parser.parse_known_args(argv)
  import jax

  jax.config.update("jax_platforms", "cpu")
  try:
    j_config, config = load_configs(args.config, overrides)
  except ValueError as e:
    parser.error(str(e))
  print(convert(j_config, config, args.workdir, args.out_workdir,
                args.step))


if __name__ == "__main__":
  main()

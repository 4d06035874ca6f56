"""Checkpoints of the train state and the data stream's position (the JAX
package's ``utils/checkpoint.py``).

A checkpoint is one file, ``{directory}/checkpoint_{step}.pt``, written
with ``torch.save`` so that a listed step is always complete: locally to
a temporary file that is then renamed over it; on a store
(``gs://``, through `utils.fileio`) into one object, which appears when
its upload ends (a store's rename is a copy and a delete, so it is not
used).  It holds G, D (with the batch
statistics and the spectral-norm ``u0``), the EMA, both Adam states (with
a learning-rate schedule's update count, ``lr_count``), the step and the
data loader's state: the position of the next batch that the training
loop has not taken (the prefetcher's batches in flight are not counted
as taken).  Restoring into a state built by
``create_train_state`` from the same configuration resumes exactly.  The
newest ``max_to_keep`` checkpoints are kept.

Over a process group (``mesh`` with more than one process) the state is
the same on every process and process 0 writes it; every process writes
its own loader's state beside it, as grain's handler does per process
(``checkpoint_{step}.loader_{r}-of-{N}.pt``), and all of them are written
before the checkpoint's file appears.  Each process restores the state
and its own loader.
"""

from __future__ import annotations

import logging
import os
import re
import time
from typing import Any, List, Optional, Tuple

import torch

from xmcgan_image_generation_tpu_torch.engine.state import TrainState
from xmcgan_image_generation_tpu_torch.parallel import collectives
from xmcgan_image_generation_tpu_torch.utils import fileio

log = logging.getLogger("xmcgan_torch")

_NAME = re.compile(r"^checkpoint_(\d+)\.pt$")


def checkpoints_dir(workdir: str) -> str:
  """The layout of the JAX package: ``{workdir}/checkpoints``."""
  return fileio.join(workdir, "checkpoints")


def list_steps(directory: str) -> List[int]:
  """The steps of the checkpoints in ``directory``, ascending."""
  if not fileio.isdir(directory):
    return []
  return sorted(int(m.group(1)) for m in map(_NAME.match,
                                             fileio.listdir(directory)) if m)


def write(payload: Any, path: str) -> None:
  """``torch.save`` of ``payload`` so that ``path`` appears whole: locally
  a temporary file renamed over it, on a store one upload, which is
  thrown away if the save fails (so no partial checkpoint is listed)."""
  if fileio.is_remote(path):
    f = fileio.open(path, "wb")
    try:
      torch.save(payload, f)
      f.close()                 # the last part: the object appears
    except BaseException:
      fileio.discard(f, path)
      raise
    return
  tmp = path + ".tmp"
  torch.save(payload, tmp)
  os.replace(tmp, path)


def load(path: str, **kwargs) -> Any:
  """``torch.load(path, weights_only=True, **kwargs)`` of a local file or
  of a seekable fsspec file of a remote one."""
  if not fileio.is_remote(path):
    return torch.load(path, weights_only=True, **kwargs)
  with fileio.open(path, "rb") as f:
    return torch.load(f, weights_only=True, **kwargs)


class CheckpointManager:
  """Saves and restores `TrainState` and, with it, a data stream that
  has ``get_state`` and ``set_state``."""

  def __init__(self, directory: str, *, max_to_keep: int = 5, mesh=None):
    self.directory = fileio.abspath(directory)
    self.max_to_keep = max_to_keep
    self.mesh = mesh if mesh is not None and mesh.world > 1 else None

  def path(self, step: int) -> str:
    return fileio.join(self.directory, f"checkpoint_{int(step)}.pt")

  def loader_path(self, step: int, rank: int,
                  world: Optional[int] = None) -> str:
    """Process ``rank``'s loader state at ``step`` in a run of ``world``
    processes (by default this manager's)."""
    world = self.mesh.world if world is None else world
    return fileio.join(self.directory,
                       f"checkpoint_{int(step)}.loader_{rank}-of-{world}.pt")

  def save(self, step: int, state: TrainState,
           data_iter: Any = None) -> Tuple[float, int]:
    """Writes the checkpoint of ``step``; returns its seconds (host clock,
    device synchronized) and the bytes this process wrote."""
    start = time.perf_counter()
    fileio.makedirs(self.directory)
    loader_bytes = 0
    if self.mesh is not None:
      if data_iter is not None:
        path = self.loader_path(step, self.mesh.rank)
        write(data_iter.get_state(), path)
        loader_bytes = fileio.getsize(path)
      collectives.barrier(self.mesh)   # every loader's state is down
      if self.mesh.rank != 0:
        return time.perf_counter() - start, loader_bytes
    payload = {
        "step": state.step,
        "generator": state.generator.state_dict(),
        "discriminator": state.discriminator.state_dict(),
        "ema_params": state.ema_params,
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
        "data_iter": data_iter.get_state() if data_iter is not None else None,
    }
    path = self.path(step)
    write(payload, path)
    for old in list_steps(self.directory)[:-self.max_to_keep]:
      fileio.remove(self.path(old))
      if self.mesh is not None:
        for rank in range(self.mesh.world):
          if fileio.exists(self.loader_path(old, rank)):
            fileio.remove(self.loader_path(old, rank))
    return (time.perf_counter() - start,
            fileio.getsize(path) + loader_bytes)

  def restore(self, step: int, state: TrainState,
              data_iter: Any = None) -> TrainState:
    """Loads the checkpoint of ``step`` into ``state`` (in place) and, when
    given, the data stream; returns ``state``."""
    device = next(state.generator.parameters()).device
    payload = load(self.path(step), map_location=device)
    state.generator.load_state_dict(payload["generator"])
    state.discriminator.load_state_dict(payload["discriminator"])
    with torch.no_grad():
      for name, value in payload["ema_params"].items():
        state.ema_params[name].copy_(value)
    state.g_opt.load_state_dict(payload["g_opt"])
    state.d_opt.load_state_dict(payload["d_opt"])
    state.step = int(payload["step"])
    if data_iter is not None and self.mesh is not None:
      path = self.loader_path(step, self.mesh.rank)
      if not fileio.exists(path):
        raise FileNotFoundError(
            f"{path}: checkpoint {step} holds no loader state for process "
            f"{self.mesh.rank} of {self.mesh.world} (written by a run of "
            f"another world size?)")
      data_iter.set_state(load(path))
    elif data_iter is not None and payload["data_iter"] is not None:
      data_iter.set_state(payload["data_iter"])
    log.info("Restored checkpoint %s", self.path(step))
    return state

  def restore_or_initialize(self, state: TrainState,
                            data_iter: Any = None) -> TrainState:
    """Restores the latest checkpoint if there is one, else returns
    ``state`` as it is."""
    step = self.latest_step()
    if step is None:
      return state
    return self.restore(step, state, data_iter)

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def agreed_latest_step(self) -> Optional[int]:
    """`latest_step` as process 0 of the ambient process group lists it,
    on every process (a checkpoint may land while the others list)."""
    latest = self.latest_step()
    step = collectives.broadcast_int(-1 if latest is None else latest)
    return None if step < 0 else step

  def all_steps(self) -> List[int]:
    return list_steps(self.directory)

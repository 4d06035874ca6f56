"""The process mesh (the JAX package's ``parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, model)`` mesh in one
program; the port runs one process per device, joined by a
``torch.distributed`` process group: NCCL for CUDA devices, gloo for the
CPU (or when asked for, as two processes that share one card must).  A
process takes its rank, the world size and its local rank from
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) or from explicit arguments, and drives
``cuda:LOCAL_RANK``.  With ``WORLD_SIZE`` unset the run is one process
with no group and no collectives, as before.  A group that fails to
start raises; nothing falls back to one process.

Beside the main group every process joins a gloo group, the control
plane on the host (``ProcessMesh.control``; `collectives.broadcast_int`,
`collectives.host_sum`, `collectives.host_barrier`), even when the main
group is NCCL: a gloo wait can be bounded (a dead peer fails it at once
or at its deadline, where it hangs an NCCL communicator until
``TIMEOUT``), and what it carries (checkpoint steps, float64 statistics)
lives on the host.  Every process creates it right after the main group,
so all create it in the same order.

The configuration's ``mesh_data`` is the ``data`` axis (-1: the world
size; any other value must equal it) and ``mesh_model`` must be 1: the
port has no model axis.  Parameters and optimizer state are replicated;
each process holds its rows of every batch.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from xmcgan_image_generation_tpu_torch.parallel import context

# How long a collective may wait for the other processes (torch's default).
TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
  """This process's place in the run.

  Attributes:
    rank / world / local_rank: as ``torchrun`` numbers them.
    device: the device this process drives.
    group: the process group, or None (one process, no collectives).
    backend: ``"nccl"`` or ``"gloo"`` (None without a group).
    owns_group: the group was started here and `MeshRules.shutdown` ends
      it.
    control: the gloo group of the control plane (None without a group);
      `MeshRules.shutdown` ends it.
  """

  rank: int
  world: int
  local_rank: int
  device: torch.device
  group: Any = None
  backend: Optional[str] = None
  owns_group: bool = False
  control: Any = None

  @property
  def is_main(self) -> bool:
    return self.rank == 0


def _resolve_device(device, local_rank: int) -> torch.device:
  device = torch.device(device)
  if device.type == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError("no CUDA device; pass device='cpu' to run on the "
                         "CPU")
    if device.index is None:
      device = torch.device("cuda", local_rank)
    torch.cuda.set_device(device)
  return device


def init_process_group(device="cuda", *, rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       local_rank: Optional[int] = None,
                       init_method: Optional[str] = None,
                       backend: Optional[str] = None) -> ProcessMesh:
  """This process's `ProcessMesh`, with a new gloo control group when it
  has a process group.

  A default group that is already up is joined as it is.  Otherwise the
  explicit arguments, else ``torchrun``'s environment, give the rank and
  world size; with neither (``WORLD_SIZE`` unset) the mesh is one process
  without a group.  ``backend`` defaults to NCCL on CUDA and gloo on the
  CPU; ``init_method`` to ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``).
  """
  env = os.environ
  if dist.is_available() and dist.is_initialized():
    rank, world = dist.get_rank(), dist.get_world_size()
    local_rank = (int(env.get("LOCAL_RANK", rank)) if local_rank is None
                  else local_rank)
    return ProcessMesh(rank, world, local_rank,
                       _resolve_device(device, local_rank),
                       dist.group.WORLD, dist.get_backend(),
                       control=_control_group())
  if world_size is None and "WORLD_SIZE" not in env:
    return ProcessMesh(0, 1, 0, _resolve_device(device, 0))
  world = int(env["WORLD_SIZE"]) if world_size is None else int(world_size)
  rank = int(env["RANK"]) if rank is None else int(rank)
  if local_rank is None:
    local_rank = int(env.get("LOCAL_RANK", rank))
  if not 0 <= rank < world:
    raise ValueError(f"rank {rank} outside a world of {world}")
  device = _resolve_device(device, local_rank)
  backend = backend or ("nccl" if device.type == "cuda" else "gloo")
  dist.init_process_group(
      backend, init_method=init_method or "env://", rank=rank,
      world_size=world, timeout=TIMEOUT)
  return ProcessMesh(rank, world, local_rank, device, dist.group.WORLD,
                     backend, owns_group=True, control=_control_group())


def _control_group():
  """A gloo group of every process (the control plane); raises when it
  does not form."""
  return dist.new_group(backend="gloo", timeout=TIMEOUT)


def data_axis_size(mesh_data: int, mesh_model: int, world: int) -> int:
  """The ``data`` axis for the configuration's ``mesh_data`` and
  ``mesh_model`` over ``world`` processes; raises naming the key."""
  if int(mesh_model) != 1:
    raise ValueError(f"mesh_model={mesh_model}: the port has no model "
                     f"axis; mesh_model must be 1")
  if int(mesh_data) == -1:
    return world
  if int(mesh_data) != world:
    raise ValueError(f"mesh_data={mesh_data} does not match the {world} "
                     f"processes of the run (-1 takes them all)")
  return world


def to_host(tree: Any) -> Any:
  """Host copies of a tree of arrays or tensors whose leaves are this
  process's rows: every process's rows, in rank order, as numpy arrays
  (the JAX package's ``process_allgather(tiled=True)``).  Without a
  process group, the leaves as numpy arrays."""
  from xmcgan_image_generation_tpu_torch.parallel import collectives

  def leaf(x):
    if isinstance(x, dict):
      return {k: leaf(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
      return type(x)(leaf(v) for v in x)
    t = torch.as_tensor(x)
    return collectives.gather_rows(t.detach()).cpu().numpy()

  return leaf(tree)


@dataclasses.dataclass(frozen=True)
class MeshRules:
  """The mesh a job runs under; `create` registers it as the ambient mesh
  (`parallel.context`), as the JAX package's does, and `shutdown` gives
  the ambient mesh back to the one it replaced."""

  mesh: ProcessMesh
  previous: Any = None

  @classmethod
  def create(cls, data: int = -1, model: int = 1, device="cuda",
             **init_kw) -> "MeshRules":
    mesh = init_process_group(device, **init_kw)
    try:
      data_axis_size(data, model, mesh.world)
    except ValueError:
      cls(mesh).shutdown()
      raise
    previous = context.get_ambient_mesh()
    context.set_ambient_mesh(mesh)
    return cls(mesh, previous)

  def shutdown(self) -> None:
    """Restores the ambient mesh and ends the groups `create` started: the
    control group, and the main group when `create` started it."""
    if context.get_ambient_mesh() is self.mesh:
      context.set_ambient_mesh(self.previous)
    if not dist.is_initialized():
      return
    if self.mesh.owns_group:
      dist.destroy_process_group()
    elif self.mesh.control is not None:
      dist.destroy_process_group(self.mesh.control)


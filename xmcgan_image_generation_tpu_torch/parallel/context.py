"""The ambient process mesh (the JAX package's ``parallel/context.py``).

The ops that pool over the global batch (BatchNorm's statistics, the
contrastive heads, the sharded word scores) read the mesh the training
run set up here instead of taking it as an argument through every module.
`mesh.MeshRules.create` sets it, as the JAX package's sets its ambient
mesh; `ambient_mesh` is a scoped override for tests and for work that one
process does alone (rank 0's image samples).  With no mesh, or a mesh
without a process group, every op is the one-device op.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

_ambient: Optional[Any] = None   # a `mesh.ProcessMesh`


def set_ambient_mesh(mesh) -> None:
  global _ambient
  _ambient = mesh


def get_ambient_mesh():
  return _ambient


def active_mesh():
  """The ambient mesh when it has a process group (collectives run, at
  any world size), else None."""
  if _ambient is None or _ambient.group is None:
    return None
  return _ambient


def ambient_data_axis_size() -> int:
  """Processes along the ``data`` axis of the ambient mesh (1 if unset)."""
  return 1 if _ambient is None else int(_ambient.world)


@contextlib.contextmanager
def ambient_mesh(mesh):
  """Scoped ambient-mesh override."""
  global _ambient
  prev = _ambient
  _ambient = mesh
  try:
    yield mesh
  finally:
    _ambient = prev

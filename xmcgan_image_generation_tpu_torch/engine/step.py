"""The outer training step: the n-critic loop over a super-batch (the JAX
package's ``engine/step.py``).

Over a process group each process passes its host rows; `train_step`
gathers them into the global super-batch, process-major as the JAX
package assembles it (process ``p``'s rows are block ``p``), and cuts it
as JAX does: D-step ``i`` takes global rows ``[i B, (i + 1) B)`` and,
with accumulation, each update's microbatches are contiguous again.
Only then does each process take its share (`local_rows`): rows ``[i B
+ r B/N, i B + (r + 1) B/N)`` of D-step ``i`` on process ``r``, and the
matching rows of each microbatch.  A process-local split would change
which examples share a contrastive pool.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from xmcgan_image_generation_tpu_torch.engine import registry
from xmcgan_image_generation_tpu_torch.engine.state import TrainState
from xmcgan_image_generation_tpu_torch.parallel import collectives
from xmcgan_image_generation_tpu_torch.parallel import context

Batch = Dict[str, torch.Tensor]


def split_batch(batch: Batch, splits: int) -> List[Batch]:
  """Splits every tensor of the batch into ``splits`` equal sub-batches."""
  for k, v in batch.items():
    if v.shape[0] % splits:
      raise ValueError(f"batch[{k!r}] of {v.shape[0]} rows does not split "
                       f"into {splits}")
  parts = {k: torch.chunk(v, splits) for k, v in batch.items()}
  return [{k: parts[k][i] for k in batch} for i in range(splits)]


def local_rows(batch: Batch) -> Batch:
  """This process's contiguous share of every tensor of a global batch
  (the batch itself without a process group)."""
  mesh = context.active_mesh()
  if mesh is None:
    return batch
  out = {}
  for name, x in batch.items():
    if x.shape[0] % mesh.world:
      raise ValueError(f"batch[{name!r}] of {x.shape[0]} rows does not "
                       f"split over {mesh.world} processes")
    rows = x.shape[0] // mesh.world
    out[name] = x[mesh.rank * rows:(mesh.rank + 1) * rows]
  return out


def stack_microbatches(batch: Batch, k: int) -> Batch:
  """``[B, ...]`` -> ``[k, B // k, ...]`` (views) for gradient
  accumulation (``config.grad_accum_steps``): microbatch ``i`` holds rows
  ``[i * B // k, (i + 1) * B // k)``, the partition of `split_batch`.
  The partition is semantics, not layout: the contrastive losses pool
  their negatives within a microbatch.  ``k <= 1`` returns the batch."""
  if k <= 1:
    return batch

  def stack(x: torch.Tensor) -> torch.Tensor:
    if x.shape[0] % k:
      raise ValueError(
          f"batch dim {x.shape[0]} not divisible by grad_accum_steps={k}")
    return x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))

  return {name: stack(x) for name, x in batch.items()}


def train_step(state: TrainState, batch: Batch, config,
               additional_data: Dict[str, Any]
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
  """One outer step: ``d_step_per_g_step - 1`` D updates, then one joint
  G+D update, on consecutive sub-batches, by the update rules of the
  configuration's ``model_name`` (`registry.get_gan_algorithm`).
  ``batch`` is this process's host super-batch (the whole one without a
  process group)."""
  gan_model = registry.get_gan_algorithm(config)
  n = config.d_step_per_g_step
  sub_batches = split_batch(collectives.gather_batch(batch), n)
  for i in range(n - 1):
    gan_model.train_d(state, sub_batches[i], config)
  metrics = gan_model.train_g_d(state, sub_batches[-1], config,
                                additional_data)
  return state, metrics

"""Sample grids from a trained checkpoint (the JAX package's
``generate.py``, ``--mode=generate``).

Restores the latest (or a given) checkpoint of a training workdir, runs
the generator with its normal and EMA weights on batches of the eval
loader, and writes PNG grids to ``{workdir}/samples``.  As in the JAX
package, the first eval batch is passed over (the JAX package builds its
models from it) and the grids show the batches after it.

Under ``torchrun --nproc_per_node=N`` each process restores the
checkpoint and generates its rows of each global batch (its shard of the
eval loader); the rows are gathered on the device
(`parallel.collectives.gather_rows`, process-major, as the JAX package's
``to_host`` of the global batch), and process 0 alone writes the grids.
"""

from __future__ import annotations

import logging
from typing import Optional

from xmcgan_image_generation_tpu_torch.data.prefetch import numeric_tensors
from xmcgan_image_generation_tpu_torch.engine.sampling import generate_batch
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.evaluate import eval_stream
from xmcgan_image_generation_tpu_torch.parallel import collectives
from xmcgan_image_generation_tpu_torch.parallel.mesh import MeshRules
from xmcgan_image_generation_tpu_torch.utils import fileio
from xmcgan_image_generation_tpu_torch.utils import image_utils
from xmcgan_image_generation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    checkpoints_dir,
)

log = logging.getLogger("xmcgan_torch")

GRIDS = ("generated_image", "ema_generated_image", "image")


def generate(config, workdir: str, device="cuda", step: Optional[int] = None,
             num_batches: int = 1) -> str:
  """Writes sample grids from a checkpoint on ``device`` (``cuda:LOCAL_RANK``
  for ``"cuda"``), over the processes of the run; returns the output
  directory."""
  rules = MeshRules.create(config.get("mesh_data", -1),
                           config.get("mesh_model", 1), device=device)
  try:
    return _generate(config, workdir, rules.mesh, step, num_batches)
  finally:
    rules.shutdown()


def _generate(config, workdir: str, mesh, step: Optional[int],
              num_batches: int) -> str:
  device = mesh.device
  ckpt = CheckpointManager(checkpoints_dir(workdir))
  if step is None:
    step = ckpt.agreed_latest_step()
  if step is None:
    raise FileNotFoundError(f"No checkpoints in {checkpoints_dir(workdir)}")
  state = ckpt.restore(step, create_train_state(config, device,
                                                seed=config.seed))
  log.info("Generating from checkpoint step %d", step)
  out_dir = fileio.join(workdir, "samples")
  if mesh.is_main:
    fileio.makedirs(out_dir)
  batches = eval_stream(config, device)
  try:
    next(batches)
    for i in range(num_batches):
      out = generate_batch(state, numeric_tensors(next(batches), device),
                           config)
      grids = {name: collectives.gather_rows(out[name], tag="samples")
               for name in GRIDS}
      if not mesh.is_main:
        continue
      for name in GRIDS:
        path = fileio.join(out_dir, f"step{step:08d}_batch{i}_{name}.png")
        image_utils.save_image(grids[name].cpu().numpy(), path,
                               config.show_num)
  finally:
    batches.close()
  if mesh.is_main:
    log.info("Wrote samples to %s", out_dir)
  return out_dir

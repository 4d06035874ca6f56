"""Sample grids from a trained checkpoint (the JAX package's
``generate.py``, ``--mode=generate``).

Restores the latest (or a given) checkpoint of a training workdir, runs
the generator with its normal and EMA weights on batches of the eval
loader, and writes PNG grids to ``{workdir}/samples``.  As in the JAX
package, the first eval batch is passed over (the JAX package builds its
models from it) and the grids show the batches after it.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from xmcgan_image_generation_tpu_torch.data.prefetch import numeric_tensors
from xmcgan_image_generation_tpu_torch.engine.sampling import generate_batch
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.evaluate import eval_stream
from xmcgan_image_generation_tpu_torch.utils import fileio
from xmcgan_image_generation_tpu_torch.utils import image_utils
from xmcgan_image_generation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    checkpoints_dir,
)

log = logging.getLogger("xmcgan_torch")


def generate(config, workdir: str, device="cuda", step: Optional[int] = None,
             num_batches: int = 1) -> str:
  """Writes sample grids from a checkpoint; returns the output directory."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device; pass device='cpu' to generate on "
                       "the CPU")
  ckpt = CheckpointManager(checkpoints_dir(workdir))
  step = step if step is not None else ckpt.latest_step()
  if step is None:
    raise FileNotFoundError(f"No checkpoints in {checkpoints_dir(workdir)}")
  state = ckpt.restore(step, create_train_state(config, device,
                                                seed=config.seed))
  log.info("Generating from checkpoint step %d", step)
  out_dir = fileio.join(workdir, "samples")
  fileio.makedirs(out_dir)
  batches = eval_stream(config, device)
  try:
    next(batches)
    for i in range(num_batches):
      out = generate_batch(state, numeric_tensors(next(batches), device),
                           config)
      for name in ("generated_image", "ema_generated_image", "image"):
        path = fileio.join(out_dir, f"step{step:08d}_batch{i}_{name}.png")
        image_utils.save_image(out[name].cpu().numpy(), path,
                               config.show_num)
  finally:
    batches.close()
  log.info("Wrote samples to %s", out_dir)
  return out_dir

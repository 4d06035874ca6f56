"""The paper's 256 px configuration (COCO-2014), in plain Python.

The same keys and values as the JAX package's ``configs/coco_xmc_256.py``:
`configs.coco_xmc` at 256 px with a batch of 256 and remat of the 256 px
scale (the last ``GenSpatialBlockFused`` and ``DiscOptimizedBlock_0``).
As there, ``get_config("test")`` is the 128 px file's test configuration
and `get_test_config` the same at 64 px.  On one card the batch of 256
takes ``--config.grad_accum_steps=2``: two microbatches of 128 an update.
"""

from __future__ import annotations

from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.configs.coco_xmc import Config


def get_config(config_string: str = "") -> Config:
  config = coco_xmc.get_config(config_string)
  if config_string == "test":
    return config
  config.update(
      image_size=256,
      batch_size=256,
      eval_batch_size=64,
      remat=True,
      remat_min_resolution=256,
  )
  return config


def get_test_config() -> Config:
  config = coco_xmc.get_test_config()
  config.image_size = 64
  return config

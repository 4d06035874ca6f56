"""InceptionV3 weights: the JAX package's converted ``.npz`` or a
deterministic random init (the JAX package's
``utils/inception_weights.py``).

The ``.npz`` holds the JAX variables tree flattened to ``'/'``-joined
paths (``params/mixed0/b0_1x1/conv/kernel``, HWIO kernels,
``batch_stats/.../mean``); `utils.bridge` maps it onto the port's
``state_dict``.  Without one the tower keeps the weights it was built
with, drawn from a generator seeded with 0: the same in every run of the
port, but not the JAX package's seed-0 init (threefry and PyTorch's
generator give other numbers), so FID on random weights differs between
the two packages.  Only bridged weights compare.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from xmcgan_image_generation_tpu_torch.models.inception_v3 import InceptionV3
from xmcgan_image_generation_tpu_torch.utils import bridge

log = logging.getLogger("xmcgan_torch")

INCEPTION_SIZE = 299


def load_or_init(model: InceptionV3,
                 ckpt_path: Optional[str] = None) -> InceptionV3:
  """Loads ``ckpt_path`` into ``model`` (every array must be there, with
  its shape) or leaves its seeded random init; returns it in eval mode
  without gradients."""
  model.eval()
  model.requires_grad_(False)
  if not ckpt_path:
    log.warning(
        "No InceptionV3 checkpoint provided: using random weights. FID/IS "
        "track relative progress only and are NOT comparable to published "
        "numbers.")
    return model
  template = bridge.flat_from_state_dict(model.state_dict())
  with np.load(ckpt_path) as npz:
    loaded = {k: npz[k] for k in npz.files}
  missing = sorted(set(template) - set(loaded))
  extra = sorted(set(loaded) - set(template))
  if missing or extra:
    raise ValueError(
        f"Inception checkpoint mismatch: missing={missing[:5]}... "
        f"extra={extra[:5]}...")
  for key, value in loaded.items():
    if tuple(value.shape) != tuple(template[key].shape):
      raise ValueError(
          f"Shape mismatch for {key}: checkpoint {value.shape} vs model "
          f"{template[key].shape}")
  model.load_state_dict(bridge.state_dict_from_flat(loaded))
  log.info("Loaded InceptionV3 weights from %s (%d arrays)", ckpt_path,
           len(loaded))
  return model

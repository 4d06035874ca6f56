"""GAN-algorithm registry (the JAX package's ``engine/registry.py``).

The training loop takes its update rules from ``config.model_name``; the
reference accepts only ``"xmc"``.
"""

from __future__ import annotations

from xmcgan_image_generation_tpu_torch.engine import xmc_gan

_ALGORITHMS = {"xmc": xmc_gan}


def get_gan_algorithm(config):
  """Returns the module implementing ``train_d``, ``train_g_d`` and
  ``create_additional_data``; raises on an unknown ``model_name``."""
  if config.model_name not in _ALGORITHMS:
    raise NotImplementedError(
        f"GAN algorithm {config.model_name!r} is not implemented; "
        f"available: {sorted(_ALGORITHMS)}")
  return _ALGORITHMS[config.model_name]

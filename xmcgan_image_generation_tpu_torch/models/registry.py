"""Architecture registry (the JAX package's ``models/registry.py``)."""

from __future__ import annotations

from typing import Tuple, Type

from torch import nn

from xmcgan_image_generation_tpu_torch.models import xmc_net

_ARCHITECTURES = {
    "xmc_net": (xmc_net.Generator, xmc_net.Discriminator),
}


def get_architecture(config) -> Tuple[Type[nn.Module], Type[nn.Module]]:
  """Returns the (generator, discriminator) classes of the configuration;
  each takes ``(config, device=..., generator=...)``."""
  if config.architecture not in _ARCHITECTURES:
    raise ValueError(
        f"Architecture {config.architecture!r} is not supported; "
        f"available: {sorted(_ARCHITECTURES)}")
  return _ARCHITECTURES[config.architecture]

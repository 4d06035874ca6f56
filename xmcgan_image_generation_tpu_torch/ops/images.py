"""On-device image dtype normalization (the JAX package's ``ops/images.py``)."""

from __future__ import annotations

import torch


def image_to_float(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
  """``uint8 [0, 255]`` or ``float [0, 1]`` image -> float ``[0, 1]``."""
  if x.dtype == torch.uint8:
    # A true division by a 255 made on the device (a fill, no copy from
    # the host, which a CUDA graph could not capture).
    return x.to(dtype) / torch.full((), 255.0, dtype=dtype, device=x.device)
  return x.to(dtype)

"""On-device image dtype normalization (the JAX package's ``ops/images.py``)."""

from __future__ import annotations

import torch


def image_to_float(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
  """``uint8 [0, 255]`` or ``float [0, 1]`` image -> float ``[0, 1]``."""
  if x.dtype == torch.uint8:
    return x.to(dtype) / torch.tensor(255.0, dtype=dtype, device=x.device)
  return x.to(dtype)

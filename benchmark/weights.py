"""Tensors drawn from the run's seed, on the device, in a few large calls.

A network's tensors are given by the reference's spec (`reference.step.
spec`: name -> shape and how to draw it).  One normal draw of all their
elements, cut at two standard deviations, is scaled a tensor at a time to
the fan-in rule of its layer (Glorot or LeCun truncated-normal variance,
as the published model initializes), to 0.02 for biases, to 1 +- 0.02
for BatchNorm scales and to 0.01 for ``u0``; BatchNorm statistics start
at 0 and 1.  The ResNet-50's classifier is drawn like its other layers
(not zero): no pretrained weights ship with the repository, and a zero
head would make the tower's loss a constant.

`sub_seed` derives independent streams (weights, data, requests) from one
seed of any size.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

Spec = Dict[str, Tuple[Tuple[int, ...], Tuple]]
TRUNCATION = 0.87962566103423978   # std of N(0, 1) cut at +-2


def sub_seed(seed: int, tag: str) -> int:
  """A 63-bit seed for the stream ``tag`` of ``seed``."""
  digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
  return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
  device = torch.device(device)
  return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _std(draw: Tuple) -> float:
  kind = draw[0]
  if kind == "glorot":
    return math.sqrt(2.0 / (draw[1] + draw[2])) / TRUNCATION
  if kind == "lecun":
    return math.sqrt(1.0 / draw[1]) / TRUNCATION
  if kind in ("bias", "scale"):
    return 0.02
  if kind == "u0":
    return 0.01
  raise ValueError(f"unknown draw {draw!r}")


def draw(spec: Spec, seed: int, tag: str, device) -> Dict[str, torch.Tensor]:
  """float32 tensors for every name of ``spec``, from ``seed``."""
  drawn = [(name, shape, d) for name, (shape, d) in spec.items()
           if d[0] not in ("zeros", "ones")]
  total = sum(math.prod(shape) for _, shape, _ in drawn)
  noise = torch.randn(total, generator=generator(seed, tag, device),
                      device=device).clamp_(-2.0, 2.0)
  out, offset = {}, 0
  for name, shape, d in drawn:
    n = math.prod(shape)
    t = noise[offset:offset + n].view(shape) * _std(d)
    out[name] = t + 1.0 if d[0] == "scale" else t
    offset += n
  for name, (shape, d) in spec.items():
    if d[0] == "zeros":
      out[name] = torch.zeros(shape, device=device)
    elif d[0] == "ones":
      out[name] = torch.ones(shape, device=device)
  return {name: out[name] for name in spec}

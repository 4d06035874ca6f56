"""Synthetic super-batches with the JAX loader's schema.

The same keys, shapes and dtypes as the batches of the JAX package's
``data/pipeline.py`` (``template_batch``), drawn in bulk from a numpy
seed: ``image`` uint8 ``[n, S, S, 3]`` (float32 in ``[0, 1]`` when
``image_uint8`` is off), ``embedding`` float32 ``[n, 17, 768]``,
``max_len`` float32 ``[n, 1]`` in 3..17, ``sentence_embedding`` float32
``[n, 768]`` and ``z`` float32 ``[n, z_dim]``, with
``n = batch_size * d_step_per_g_step`` (or the size asked for).
`SyntheticStream` is the endless stream a run draws from; its state (the
seed, the count of batches drawn and the numpy generator's state) goes
into the checkpoint, so a resumed run draws the batches an uninterrupted
one would have.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

TEXT_LEN = 17     # COCO caption length (data/constants.py of the JAX package)
BERT_DIM = 768


def super_batch(config, rng: np.random.Generator,
                n: Optional[int] = None) -> Dict[str, np.ndarray]:
  """One super-batch of ``batch_size * d_step_per_g_step`` examples, or of
  ``n``."""
  n = n or config.batch_size * config.d_step_per_g_step
  s = config.image_size
  if config.get("image_uint8", True):
    image = rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)
  else:
    image = rng.random((n, s, s, 3), dtype=np.float32)
  return {
      "image": image,
      "embedding": rng.standard_normal((n, TEXT_LEN, BERT_DIM),
                                       dtype=np.float32),
      "max_len": rng.integers(3, TEXT_LEN + 1, (n, 1)).astype(np.float32),
      "sentence_embedding": rng.standard_normal((n, BERT_DIM),
                                                dtype=np.float32),
      "z": rng.standard_normal((n, config.z_dim), dtype=np.float32),
  }


class SyntheticStream:
  """An endless, seed-determined stream of batches of ``n`` examples
  (super-batches by default) with a checkpointable position."""

  def __init__(self, config, seed: int, n: Optional[int] = None):
    self.config = config
    self.seed = seed
    self.n = n
    self.count = 0
    self._rng = np.random.default_rng(seed)

  def __iter__(self) -> "SyntheticStream":
    return self

  def __next__(self) -> Dict[str, np.ndarray]:
    self.count += 1
    return super_batch(self.config, self._rng, self.n)

  def get_state(self) -> Dict[str, Any]:
    return {"seed": self.seed, "count": self.count,
            "bit_generator": self._rng.bit_generator.state}

  def set_state(self, state: Dict[str, Any]) -> None:
    if state["seed"] != self.seed:
      raise ValueError(f"the checkpoint's stream has seed {state['seed']}, "
                       f"this one {self.seed}")
    self.count = int(state["count"])
    self._rng.bit_generator.state = state["bit_generator"]


def super_batches(config, seed: int) -> SyntheticStream:
  """The stream of super-batches of a training run."""
  return SyntheticStream(config, seed)

"""Synthetic super-batches with the JAX loader's schema.

The same keys, shapes and dtypes as the batches of the JAX package's
``data/pipeline.py`` (``template_batch``), drawn in bulk from a numpy
seed: ``image`` uint8 ``[n, S, S, 3]`` (float32 in ``[0, 1]`` when
``image_uint8`` is off), ``embedding`` float32 ``[n, 17, 768]``,
``max_len`` float32 ``[n, 1]`` in 3..17, ``sentence_embedding`` float32
``[n, 768]`` and ``z`` float32 ``[n, z_dim]``, with
``n = batch_size * d_step_per_g_step`` (or the size asked for).  Tests
draw one super-batch with it; training and evaluation take theirs from
`data.pipeline`, whose synthetic source is the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional

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

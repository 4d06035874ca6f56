"""Sampling from the generator with its normal and EMA weights (the JAX
package's ``engine/sampling.py``).

G runs in eval mode (``train=False`` in JAX): BatchNorm uses its running
statistics and writes none.  The EMA weights stand in for G's parameters
through ``torch.func.functional_call``; G's buffers are its own.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.func import functional_call

from xmcgan_image_generation_tpu_torch.engine.state import TrainState
from xmcgan_image_generation_tpu_torch.ops.images import image_to_float

BERT_DIM = 768
TEXT_LEN = 17

Batch = Dict[str, torch.Tensor]


def generate_batch(state: TrainState, batch: Batch, config,
                   rng: Optional[torch.Generator] = None) -> Batch:
  """Images for ``batch``'s conditions with both weight sets.

  Returns float32 NHWC images in [0, 1]: ``generated_image``,
  ``ema_generated_image`` and the real ``image``.  The latent is
  ``batch["z"]`` when the batch has one, else drawn from ``rng``.
  """
  g_net = state.generator
  if "z" in batch:
    z = batch["z"]
  else:
    device = batch["image"].device
    z = torch.randn((batch["image"].shape[0], config.z_dim), device=device,
                    generator=rng)
  cond = {k: batch[k] for k in ("sentence_embedding", "embedding",
                                "max_len")}
  was_training = g_net.training
  g_net.eval()
  try:
    with torch.no_grad():
      generated = g_net(cond, z)
      ema_generated = functional_call(g_net, state.ema_params, (cond, z))
  finally:
    g_net.train(was_training)
  return dict(generated_image=generated.float(),
              ema_generated_image=ema_generated.float(),
              image=image_to_float(batch["image"]))


def generate_sample(state: TrainState, config, sample_size: int = 0,
                    rng: Optional[torch.Generator] = None,
                    device=None) -> Batch:
  """Samples from random conditions: normal sentence and word features,
  caption lengths 3..17, drawn from ``rng`` on ``device``."""
  n = sample_size or min(config.show_num, config.batch_size)
  kw = dict(device=device, generator=rng)
  batch = {
      "sentence_embedding": torch.randn((n, BERT_DIM), **kw),
      "embedding": torch.randn((n, TEXT_LEN, BERT_DIM), **kw),
      "max_len": torch.randint(3, TEXT_LEN + 1, (n, 1), **kw).float(),
      "image": torch.zeros((n, config.image_size, config.image_size, 3),
                           device=device),
      "z": torch.randn((n, config.z_dim), **kw),
  }
  out = generate_batch(state, batch, config)
  del out["image"]
  return out

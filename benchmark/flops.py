"""Floating-point operations of one outer training step, counted on the
reference.

`step_flops` runs the reference's outer step (`reference.step`) on the
``meta`` device at a configuration's shapes under
``torch.utils.flop_counter.FlopCounterMode``, which counts the
convolutions and matrix products, forward and backward.  The count is the
step's whatever implements it, so the port's CUDA kernels (invisible to
the counter) and its recomputation under remat (the reference recomputes
nothing here) do not change it.  The word and sentence heads count in
their einsum form.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import nets, step as ref


def _meta(spec_of_net):
  return {name: torch.zeros(shape, device="meta")
          for name, (shape, _) in spec_of_net.items()}


def step_flops(cfg) -> int:
  """Operations of one outer step over a super-batch of ``batch_size *
  d_step_per_g_step`` examples."""
  spec = ref.spec(cfg)
  state = ref.new_state(cfg, _meta(spec["g"]), _meta(spec["d"]),
                        _meta(spec["tower"]), ref.trained(spec["g"]),
                        ref.trained(spec["d"]))
  n, s = cfg["batch_size"] * cfg["d_step_per_g_step"], cfg["image_size"]
  batch = {"image": torch.zeros(n, s, s, 3, dtype=torch.uint8, device="meta"),
           "embedding": torch.zeros(n, nets.TEXT_LEN, nets.BERT_DIM,
                                     device="meta"),
           "max_len": torch.zeros(n, 1, device="meta"),
           "sentence_embedding": torch.zeros(n, nets.BERT_DIM, device="meta"),
           "z": torch.zeros(n, cfg["z_dim"], device="meta")}
  with FlopCounterMode(display=False) as counter:
    ref.outer_step(state, batch, cfg)
  return counter.get_total_flops()

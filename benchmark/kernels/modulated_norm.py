"""The modulated-norm family, ``csrc/modulated_norm.cu``: G's train-mode
conditional BatchNorms as a statistics kernel and a normalize, modulate
and ReLU kernel forward (``modnorm_stats``, ``modnorm_apply``) and two
backward (``modnorm_bwd_reduce``, ``modnorm_bwd_dx``), once a norm each.

Every name holds ``norm`` and none of the fragments that
`benchmark.trace.GROUPS` matches before its reduction group, so the
family's time stays in that group.  Its launches run at every norm's own
shape, 11 of them at 128 px and 13 at 256 px, so the family gives its
time a step (``norm_ms.train``) and no bound a launch.  A checkout whose
port has no such module has no counters here (the benchmark's traced
runs lay these files over an older checkout too).
"""

from __future__ import annotations

import importlib.util

_PORT = "xmcgan_image_generation_tpu_torch.ops.cuda.modulated_norm"


def _counters():
  if importlib.util.find_spec(_PORT) is None:
    return {}
  return {op: (_PORT, f"norm_{op}")
          for op in ("stats", "apply", "bwd_reduce", "bwd_dx")}


COUNTERS = _counters()
NAMES = ("modnorm_stats", "modnorm_apply", "modnorm_bwd_reduce",
         "modnorm_bwd_dx")

"""Kernel A, ``csrc/ntxent.cu``: the symmetric NT-Xent statistics of two
L2-normalized ``[B, F]`` feature sets (``ntxent_fwd``) and its gradient
(``ntxent_bwd``), on the inputs' precision, bfloat16 here (D's compute
dtype).

The forward forms the ``B x B`` logits (2 B^2 F) and normalizes both
sets (6 B F); it reads both sets and writes three floats and the record
the backward reads (the logits and 7 B floats of row and column
statistics).  The backward forms two ``[B, B] x [B, F]`` products (4 B^2
F, 8 B F around them); it reads both sets, the record and the cotangent
and writes both gradients.  These are PERF.md section 6's counts.  The
bound is the larger of the bytes over the memory rate and the operations
over the tensor cores' rate for the inputs' dtype.
"""

from __future__ import annotations

from typing import Dict

from benchmark import peaks

COUNTERS = {
    "fwd": ("xmcgan_image_generation_tpu_torch.ops.cuda.ntxent",
            "ntxent_stats"),
    "bwd": ("xmcgan_image_generation_tpu_torch.ops.cuda.ntxent",
            "ntxent_bwd"),
}
NAMES = ("ntxent_fwd", "ntxent_bwd")
# D's pooled features: the last block's channels, df_dim times these.
POOL_MULTIPLIER = {32: 8, 64: 16, 128: 16, 256: 16}


def shapes(cfg) -> Dict[str, int]:
  rows = cfg["batch_size"] // cfg["grad_accum_steps"]
  return {"batch": rows,
          "dim": cfg["df_dim"] * POOL_MULTIPLIER[cfg["image_size"]],
          "itemsize": 2 if cfg["dtype"] == "bfloat16" else 4}


def operations_and_bytes(batch, dim, itemsize):
  """``{op: (operations, bytes)}`` of one launch of each op."""
  record = 4 * (batch * batch + 7 * batch)
  feats = itemsize * batch * dim
  return {
      "fwd": (2 * batch * batch * dim + 6 * batch * dim,
              2 * feats + 12 + record),
      "bwd": (4 * batch * batch * dim + 8 * batch * dim,
              4 * feats + record + 4),
  }


def launch_bounds(cfg) -> Dict[str, float]:
  rate = peaks.FLOPS["bfloat16" if cfg["dtype"] == "bfloat16" else "tf32"]
  return {op: max(ops / rate, nbytes / peaks.HBM_BYTES_PER_S)
          for op, (ops, nbytes)
          in operations_and_bytes(**shapes(cfg)).items()}

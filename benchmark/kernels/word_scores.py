"""Kernels B-D, ``csrc/word_scores.cu``: the AttnGAN word-region scores
of I images against C captions (R regions, L words, D features, float32)
and their gradient with respect to the regions and to the words.

An op's bound is the larger of its bytes over the memory rate (each
input read once, each output written once) and its operations over the
tensor cores' TF32 rate (the card's rate on float32 inputs).  The
operations are those of PERF.md section 6 (`section6_operations`): the
similarities ``S = rn wn^T`` (2 I C R L D), the regions' Gram matrix
(2 I R^2 D) and ``G alpha`` (2 I C L R^2).  The forward's launch does not
form the Gram matrix (``torch.bmm`` does, before it, outside these
kernels' time), so its bound counts the Gram matrix's bytes as an input
instead of its operations.  What the forward saves for the gradients is
the kernels' own record, left out of the bytes.
"""

from __future__ import annotations

from typing import Dict

from benchmark import peaks
from benchmark.reference import nets

COUNTERS = {
    "scores": ("xmcgan_image_generation_tpu_torch.ops.cuda.word_scores",
               "scores"),
    "drn": ("xmcgan_image_generation_tpu_torch.ops.cuda.word_scores", "drn"),
    "dwn": ("xmcgan_image_generation_tpu_torch.ops.cuda.word_scores", "dwn"),
}
NAMES = ("scores_fwd", "scores_drn_chain", "scores_dwn_chain", "scores_gemm",
         "sum_parts")


def shapes(cfg) -> Dict[str, int]:
  """I = C = the rows of a microbatch; R the regions of D's
  ``cond_size`` map."""
  rows = cfg["batch_size"] // cfg["grad_accum_steps"]
  return {"images": rows, "captions": rows, "regions": cfg["cond_size"] ** 2,
          "words": nets.TEXT_LEN, "dim": nets.BERT_DIM}


def section6_operations(images, captions, regions, words, dim):
  """The three products of PERF.md section 6."""
  return {"sim": 2 * images * captions * regions * words * dim,
          "gram": 2 * images * regions * regions * dim,
          "g_alpha": 2 * images * captions * words * regions * regions}


def operations_and_bytes(images, captions, regions, words, dim):
  """``{op: (operations, bytes)}`` of one launch of each op."""
  p = section6_operations(images, captions, regions, words, dim)
  rn, wn = 4 * images * regions * dim, 4 * captions * words * dim
  mask, scores = 4 * captions * words, 4 * images * captions
  gram = 4 * images * regions * regions
  return {
      "scores": (p["sim"] + p["g_alpha"], rn + wn + mask + gram + scores),
      "drn": (p["sim"] + p["g_alpha"] + p["gram"],
              rn + wn + mask + scores + rn),
      "dwn": (p["sim"], rn + wn + mask + scores + wn),
  }


def launch_bounds(cfg) -> Dict[str, float]:
  """Seconds a launch of each op takes at least."""
  return {op: max(ops / peaks.FLOPS["tf32"], nbytes / peaks.HBM_BYTES_PER_S)
          for op, (ops, nbytes)
          in operations_and_bytes(**shapes(cfg)).items()}

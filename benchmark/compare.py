"""The comparison that decides ``correct``.

Training: the timed path's first three outer steps against the
reference's, from the same seeded weights and super-batches.  Both sides
give `Readings`; `train_numbers` reduces a pair to these numbers:

* ``loss``: the largest gap of the five losses over the three steps, over
  the reference's magnitude (at least 1);
* ``contrastive1``: the same of step 1's contrastive losses (``c_loss_d``,
  ``c_loss_g``, ``c_loss_g_pretrained``: the word and sentence heads on
  the port's kernels, and the ResNet-50 term);
* ``grad``: the first gradient as the optimizer holds it, Adam's first
  moment after step 1, by the worst leaf that moves (`moved`): the gap
  between the two sides' norms of a leaf over the reference's norm of
  that leaf or of the median leaf of its network, whichever is larger;
* ``change`` and ``change_median``: the same of each parameter's change
  over the three steps, the worst and the median leaf that moves;
* ``ema``: the worst leaf of the EMA's change; ``bn``: of the change of
  G's BatchNorm running averages over the three steps;
* ``bn1``: G's BatchNorm running averages after step 1, which the joint
  update's forward of the initial G writes before any update of G: the
  norm of the difference of all of them over the norm of the reference's
  change from their start.

Leaves whose gradient is nought to rounding in the reference (a conv's
bias ahead of a BatchNorm: the mean is taken out) move under Adam by
round-off alone on either side; `moved` leaves them out of ``grad`` and
the changes by the reference's gradient, not by name.  A cell's workload
file names the numbers it holds to a limit; PERF.md gives the readings
of the others.

Serving: ``image`` is the largest gap of a pixel between an image that
the timed path returned and the reference's image for the same request;
``image_rms`` the root mean square of the gaps over every pixel served.

A run is correct when every number with a limit is finite and within it.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Optional, Set

import torch

MOVED_SHARE = 1e-3
CONTRASTIVE = ("c_loss_d", "c_loss_g", "c_loss_g_pretrained")


@dataclasses.dataclass
class Readings:
  """What one side's first steps give (norms as floats, vectors on the
  host)."""
  losses: List[Dict[str, float]]
  m1: Dict[str, Dict[str, float]]       # net -> leaf -> |Adam m| after 1
  bn1: Dict[str, torch.Tensor]          # G's BatchNorm averages after 1
  change: Dict[str, Dict[str, float]]   # net -> leaf -> |p3 - p0|
  ema: Dict[str, float]                 # leaf -> |ema3 - p0|
  bn: Dict[str, float]                  # G buffer -> |b3 - b0|


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
  """Each tensor's l2 norm, read from the device at once."""
  if not tensors:
    return {}
  names = list(tensors)
  values = torch.stack([tensors[n].detach().float().norm() for n in names])
  return dict(zip(names, values.cpu().tolist()))


def moved(ref_m1: Dict[str, float], share: float = MOVED_SHARE) -> Set[str]:
  """The leaves whose reference gradient is at least ``share`` of the
  median leaf's."""
  floor = share * statistics.median(ref_m1.values())
  return {n for n, v in ref_m1.items() if v >= floor}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Set[str]] = None) -> Dict[str, float]:
  """Each leaf's gap of norms over the larger of its reference norm and
  the median leaf's."""
  names = [n for n in ref if keep is None or n in keep]
  floor = statistics.median(ref[n] for n in names)
  return {n: abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30)
          for n in names}


def gap_of_norms(prog, ref, keep=None) -> float:
  return max(leaf_gaps(prog, ref, keep).values())


def _loss_gaps(prog: Readings, ref: Readings, steps, names):
  return max((abs(p[k] - r[k]) / max(abs(r[k]), 1.0), f"step {i + 1} {k}")
             for i, (p, r) in enumerate(zip(prog.losses, ref.losses))
             if i in steps for k in names)


def _worst(gaps: Dict[str, float]):
  return max((g, n) for n, g in gaps.items())


def train_numbers(prog: Readings, ref: Readings,
                  where: Optional[Dict[str, str]] = None
                  ) -> Dict[str, float]:
  """The numbers of the comparison; ``where``, when given, receives the
  step and loss or the leaf that sets each."""
  keep = {net: moved(ref.m1[net]) for net in ref.m1}
  change = {net: leaf_gaps(prog.change[net], ref.change[net], keep[net])
            for net in ref.change}
  start = {n: torch.ones_like(v) if n.endswith(".var") else torch.zeros_like(v)
           for n, v in ref.bn1.items()}
  found = {
      "loss": _loss_gaps(prog, ref, range(len(ref.losses)),
                         ref.losses[0].keys()),
      "contrastive1": _loss_gaps(prog, ref, (0,), CONTRASTIVE),
      "grad": max(_worst(leaf_gaps(prog.m1[n], ref.m1[n], keep[n]))
                  for n in ref.m1),
      "change": max(_worst(g) for g in change.values()),
      "change_median": (max(statistics.median(g.values())
                            for g in change.values()), "median leaf"),
      "ema": _worst(leaf_gaps(prog.ema, ref.ema, keep["g"])),
      "bn": _worst(leaf_gaps(prog.bn, ref.bn)),
      "bn1": (math.sqrt(
          sum(float((prog.bn1[n] - ref.bn1[n]).norm()) ** 2 for n in ref.bn1)
          / sum(float((ref.bn1[n] - start[n]).norm()) ** 2
                for n in ref.bn1)), "all of G's BatchNorms"),
  }
  if where is not None:
    where.update({k: v[1] for k, v in found.items()})
  return {k: v[0] for k, v in found.items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
  """``{name: {"value", "limit"}}`` of every number that has a limit."""
  return {name: {"value": numbers[name], "limit": limits[name]}
          for name in limits}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
  return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())

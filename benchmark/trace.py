"""The traced run: the card's activity in the window, and what the host
was doing meanwhile.

`Tracer` runs ``torch.profiler`` over the measured window with CUDA
activity alone (with the host's activity recorded too, a
``record_function`` range such as the optimizer's comes back as a device
event over its kernels and counts their time twice).  `Trace` holds every
device operation (kernels, copies, fills) as ``(name, start_ns, end_ns)``
and the harness's own host spans in the same clock, and reduces them:
the union of the operations' intervals (busy time), the idle gaps and the
host span each falls in, device time by kernel and by group of kernel
names (`GROUPS`, a frozen copy of the port's ``profile_step.GROUPS``,
with the copy engine's transfers apart).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

Interval = Tuple[str, int, int]

# Kernel-name fragments of each group, first match wins.
GROUPS = (
    ("transfers", ("memcpy", "memset")),
    ("port kernels", ("ntxent_", "scores_fwd", "scores_drn", "scores_dwn",
                      "scores_gemm", "sum_parts")),
    ("convolution", ("conv", "cudnn", "implicit", "dgrad", "wgrad", "fprop",
                     "xmma", "nchw", "nhwc")),
    ("matmul", ("gemm", "cutlass", "sm90", "ampere", "splitk")),
    ("optimizer", ("multi_tensor", "adam", "foreach")),
    ("reduction", ("reduce", "norm", "softmax", "logsumexp")),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "cat",
                            "fill", "index", "upsample", "pool")),
)


def group(name: str) -> str:
  low = name.lower()
  for label, keys in GROUPS:
    if any(k in low for k in keys):
      return label
  return "other"


def now_ns() -> int:
  """The host clock the profiler stamps its events with."""
  return time.time_ns()


class Spans:
  """The harness's host spans of the window: ``(name, start_ns, end_ns)``."""

  def __init__(self):
    self.items: List[Interval] = []

  def add(self, name: str, start_ns: int, end_ns: int) -> None:
    self.items.append((name, start_ns, end_ns))


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
  merged: List[List[int]] = []
  for start, end in sorted(intervals):
    if merged and start <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], end)
    else:
      merged.append([start, end])
  return [(a, b) for a, b in merged]


@dataclasses.dataclass
class Trace:
  ops: List[Interval]          # device operations
  start_ns: int                # the window, on the host clock
  end_ns: int
  spans: List[Interval]

  @property
  def window_s(self) -> float:
    return (self.end_ns - self.start_ns) / 1e9

  def busy_intervals(self) -> List[Tuple[int, int]]:
    return _union((a, b) for _, a, b in self.ops)

  @property
  def busy_s(self) -> float:
    return sum(b - a for a, b in self.busy_intervals()) / 1e9

  def aligned(self) -> bool:
    """Whether the device's stamps fall inside the host's window (the
    profiler converts them to the host clock)."""
    if not self.ops:
      return False
    slack = 50_000_000
    return (min(a for _, a, _ in self.ops) >= self.start_ns - slack
            and max(b for _, _, b in self.ops) <= self.end_ns + slack)

  def idle_intervals(self) -> List[Tuple[int, int]]:
    out, cursor = [], self.start_ns
    for a, b in self.busy_intervals():
      if a > cursor:
        out.append((cursor, min(a, self.end_ns)))
      cursor = max(cursor, b)
    if cursor < self.end_ns:
      out.append((cursor, self.end_ns))
    return [(a, b) for a, b in out if b > a]

  def device_seconds(self, fragments: Optional[Sequence[str]] = None,
                     groups: Optional[Sequence[str]] = None) -> float:
    """Summed duration of the operations whose name holds one of
    ``fragments`` or whose group is one of ``groups``."""
    total = 0
    for name, a, b in self.ops:
      if ((fragments and any(f in name for f in fragments))
          or (groups and group(name) in groups)):
        total += b - a
    return total / 1e9

  def by_kernel(self) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, a, b in self.ops:
      out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out

  def idle_by_span(self) -> Dict[str, float]:
    """Idle seconds of the card by the host span they fall in
    (``outside spans`` where none; ``unaligned`` when the clocks do not
    agree)."""
    idle = self.idle_intervals()
    if not self.aligned():
      return {"unaligned": sum(b - a for a, b in idle) / 1e9}
    spans = sorted((a, b, name) for name, a, b in self.spans)
    out: Dict[str, float] = {}
    j = 0
    for a, b in idle:
      covered = 0
      while j < len(spans) and spans[j][1] <= a:
        j += 1
      k = j
      while k < len(spans) and spans[k][0] < b:
        sa, sb, name = spans[k]
        part = min(b, sb) - max(a, sa)
        if part > 0:
          out[name] = out.get(name, 0.0) + part / 1e9
          covered += part
        k += 1
      if b - a > covered:
        out["outside spans"] = (out.get("outside spans", 0.0)
                                + (b - a - covered) / 1e9)
    return out

  def breakdown(self, top: int = 10) -> Dict[str, list]:
    kernels = sorted(self.by_kernel().items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(self.idle_by_span().items(), key=lambda kv: -kv[1])[:top]
    return {
        "device_ops": [[f"{group(name)}: {name[:120]}", seconds]
                       for name, seconds in kernels],
        "idle_gaps": [[f"host in {name}", seconds] for name, seconds in idle],
    }


def _stamp(event, name: str) -> int:
  if hasattr(event, f"{name}_ns"):
    return int(getattr(event, f"{name}_ns")())
  return int(getattr(event, f"{name}_us")() * 1000)


class Tracer:
  """``with Tracer() as t: ...`` records the card's operations; `trace`
  then gives the `Trace` of a window and its spans."""

  def __enter__(self) -> "Tracer":
    self._prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    self._prof.__enter__()
    return self

  def __exit__(self, *exc) -> None:
    self._prof.__exit__(*exc)

  def trace(self, start_ns: int, end_ns: int, spans: Spans) -> Trace:
    ops = []
    for e in self._prof.profiler.kineto_results.events():
      if (e.device_type() != torch.autograd.DeviceType.CUDA
          or getattr(e, "is_user_annotation", lambda: False)()):
        continue
      start = _stamp(e, "start")
      end = start + int(e.duration_ns() if hasattr(e, "duration_ns")
                        else e.duration_us() * 1000)
      if end > start:
        ops.append((e.name(), start, end))
    return Trace(ops=ops, start_ns=start_ns, end_ns=end_ns,
                 spans=list(spans.items))

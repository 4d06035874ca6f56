"""The port's own spans of a traced training window
(``xmcgan_image_generation_tpu_torch.utils.tracing``), for the per-layer
metrics that read them.

The port records its spans only while a profiler capture runs, so in a
``--trace 1`` run the window's steps are recorded: ``step`` (from asking
for the super-batch to the step's return), ``data.wait`` inside it, and
the leaves ``forward``, ``backward``, ``reduce_grads``, ``adam`` and
``ema``, which never overlap.  Their stamps are on the clock the
profiler converts the card's operations to, so `idle_ms` lays the leaves
over the window's operations and reduces them with
`benchmark.trace.Trace.idle_by_span`.  Every reading is a mean a step
over the window's steps, and is None where there is nothing to read: no
trace, not a training record, a port without the recorder, a record that
has dropped spans, or a window whose ``step`` spans do not number its
steps.

The traced runs of every cell lay this benchmark over the checkouts of
both commits compared, and an older port has no recorder: there the
import fails and every reading is None.

At 256 px the host blocks on the card's full launch queue, so the host
readings there (`host_ms`) time the device's backlog, not host work.
"""

from __future__ import annotations

from typing import Optional, Sequence

from benchmark import trace

LEAVES = ("forward", "backward", "reduce_grads", "adam", "ema")


def window_spans(record) -> Optional[list]:
  """The port's spans that lie inside the traced window, or None."""
  if (record.kind != "train" or record.trace is None
      or not getattr(record, "steps", 0)):
    return None
  try:
    from xmcgan_image_generation_tpu_torch.utils import tracing
  except ImportError:
    return None
  if tracing.dropped():
    return None
  t = record.trace
  spans = [s for s in tracing.spans()
           if t.start_ns <= s.start_ns and s.end_ns <= t.end_ns]
  if sum(s.name == "step" for s in spans) != record.steps:
    return None
  return spans


def host_ms(record, names: Sequence[str]) -> Optional[float]:
  """Host ms a step inside the spans named ``names``."""
  spans = window_spans(record)
  if spans is None:
    return None
  total = sum(s.end_ns - s.start_ns for s in spans if s.name in names)
  return total / 1e6 / record.steps


def idle_ms(record, names: Sequence[str]) -> Optional[float]:
  """Device-idle ms a step while the host is in one of the leaves
  ``names``."""
  spans = window_spans(record)
  if spans is None or not record.trace.aligned():
    return None
  leaves = [(s.name, s.start_ns, s.end_ns) for s in spans
            if s.name in LEAVES]
  if not leaves:
    return None
  t = record.trace
  idle = trace.Trace(ops=t.ops, start_ns=t.start_ns, end_ns=t.end_ns,
                     spans=leaves).idle_by_span()
  return 1e3 * sum(idle.get(name, 0.0) for name in names) / record.steps

"""Host spans of the training step, on the clock the profiler stamps the
card's operations with.

``with span("forward"): ...`` marks a phase of the outer step.  A span
records only while a ``torch.profiler`` capture runs (the trainer's
``profile=True``, or any tool that profiles the step); outside one it is
a single check that returns a shared no-op context, with no clock read
and no allocation.

While a capture runs a span stores its name and ``time.time_ns()`` at
entry and exit: the host clock that ``torch.profiler`` converts its host
and device stamps to, so a span can be laid over the device's
operations.  It also enters ``torch.profiler.record_function``, so the
capture's own trace shows the step and its phases; ``step`` is entered
there as ``step#<n>``, the outer step's number, the port's counterpart of
the JAX package's ``jax.profiler.StepTraceAnnotation``.

Finished spans are kept in memory, the oldest dropped beyond
``CAPACITY`` and counted by `dropped`; nothing is written out.  `spans`
returns them and `clear` empties the record.  The step's spans: ``step``
(``train.timed_step``), ``data.wait`` (its wait for the super-batch),
``d_update`` and ``gd_update`` (one critic or joint update), and under
them the leaves, which never overlap: ``forward`` and ``backward`` (once
a microbatch), ``reduce_grads`` (the float32 sums over microbatches and
the sum over processes), ``adam`` (each optimizer's apply) and ``ema``.
Where the updates run as CUDA graphs (`engine.graphed`), an update's
``forward`` and ``backward`` give way to ``graph_replay`` (one replay),
and ``graph_capture`` marks the capture, once an update; neither is a
leaf.  All are opened on the training thread.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16

_OFF = contextlib.nullcontext()


class Span(NamedTuple):
  name: str
  start_ns: int
  end_ns: int


_spans = collections.deque(maxlen=CAPACITY)
_dropped = 0


def span(name: str, step: Optional[int] = None):
  """A context manager that records ``name`` while a profiler capture
  runs; ``step`` numbers the outer step in the capture's trace."""
  if not _profiler._is_profiler_enabled:
    return _OFF
  return _Open(name, name if step is None else f"{name}#{step}")


def spans() -> List[Span]:
  return list(_spans)


def dropped() -> int:
  """Spans the record has dropped since its last `clear`."""
  return _dropped


def clear() -> None:
  """Empties the record, bounded at the current ``CAPACITY``."""
  global _spans, _dropped
  _spans = collections.deque(maxlen=CAPACITY)
  _dropped = 0


class _Open:
  """A span being recorded."""

  __slots__ = ("_name", "_range", "_start_ns")

  def __init__(self, name: str, label: str):
    self._name = name
    self._range = torch.profiler.record_function(label)

  def __enter__(self) -> None:
    self._range.__enter__()
    self._start_ns = time.time_ns()

  def __exit__(self, *exc) -> None:
    end_ns = time.time_ns()
    self._range.__exit__(*exc)
    global _dropped
    if len(_spans) == _spans.maxlen:
      _dropped += 1
    _spans.append(Span(self._name, self._start_ns, end_ns))

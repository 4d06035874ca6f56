"""Kernels B-D's share of their roofline: the launches in the window (the
port's counters) times each op's least time at the cell's shapes
(`benchmark.kernels.word_scores`), over the device time of their kernels
in the trace."""

from benchmark.kernels import word_scores as family


def read(record):
  if record.trace is None:
    return None
  bounds = family.launch_bounds(record.cfg)
  least = sum(record.counters.get(f"word_scores.{op}", 0) * seconds
              for op, seconds in bounds.items())
  spent = record.trace.device_seconds(family.NAMES)
  if least <= 0 or spent <= 0:
    return None
  return 100.0 * least / spent

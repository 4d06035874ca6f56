"""Kernel A's share of its roofline: the launches in the window (the
port's counters) times each op's least time at the cell's shapes
(`benchmark.kernels.ntxent`), over the device time of its kernels in the
trace."""

from benchmark.kernels import ntxent as family


def read(record):
  if record.trace is None:
    return None
  bounds = family.launch_bounds(record.cfg)
  least = sum(record.counters.get(f"ntxent.{op}", 0) * seconds
              for op, seconds in bounds.items())
  spent = record.trace.device_seconds(family.NAMES)
  if least <= 0 or spent <= 0:
    return None
  return 100.0 * least / spent

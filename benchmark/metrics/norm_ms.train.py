"""Device ms a step of the modulated-norm kernels
(`benchmark.kernels.modulated_norm`): G's conditional BatchNorms, forward
and backward; None where the port's counters show no launch of the family
in the window."""

from benchmark.kernels import modulated_norm as family


def read(record):
  if record.kind != "train" or record.trace is None or not record.steps:
    return None
  if not any(record.counters.get(f"modulated_norm.{op}", 0)
             for op in family.COUNTERS):
    return None
  return 1e3 * record.trace.device_seconds(family.NAMES) / record.steps

"""The whole step's share of the card's bfloat16 peak: the reference
step's operations at the cell's shapes (`benchmark.flops`) times the
steps completed, over the traced window, over 989 TFLOP/s."""

from benchmark import flops, peaks


def read(record):
  if record.kind != "train" or record.trace is None or not record.steps:
    return None
  done = flops.step_flops(record.cfg) * record.steps
  return 100.0 * done / record.trace.window_s / peaks.FLOPS["bfloat16"]

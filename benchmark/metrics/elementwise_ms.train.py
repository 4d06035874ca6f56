"""Device ms a step of the kernels in the elementwise / copy and reduction
groups of `benchmark.trace.GROUPS`: the work around BatchNorm and the
conditional modulation that eager PyTorch leaves unfused."""


def read(record):
  if record.kind != "train" or record.trace is None or not record.steps:
    return None
  seconds = record.trace.device_seconds(
      groups=("elementwise / copy", "reduction"))
  return 1e3 * seconds / record.steps

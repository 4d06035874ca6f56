"""Device-idle ms a step while the host is in the port's ``forward``
spans (G, D, the heads and the ResNet-50 tower, up to the losses)."""

from benchmark import program_spans


def read(record):
  return program_spans.idle_ms(record, ("forward",))

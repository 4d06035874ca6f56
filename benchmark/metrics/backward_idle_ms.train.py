"""Device-idle ms a step while the host is in the port's ``backward``
spans (the ``torch.autograd.grad`` pulls)."""

from benchmark import program_spans


def read(record):
  return program_spans.idle_ms(record, ("backward",))

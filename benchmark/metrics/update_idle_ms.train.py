"""Device-idle ms a step while the host is in the port's
``reduce_grads``, ``adam`` or ``ema`` spans: the gradient sums, the
three Adam applies and the EMA."""

from benchmark import program_spans


def read(record):
  return program_spans.idle_ms(record, ("reduce_grads", "adam", "ema"))

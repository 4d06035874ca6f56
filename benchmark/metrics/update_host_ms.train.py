"""Host ms a step in the port's ``reduce_grads``, ``adam`` and ``ema``
spans.  At 256 px (``xmc256-train``) the host blocks on the card's full
launch queue inside these spans, so there it reads the device's backlog,
not host work."""

from benchmark import program_spans


def read(record):
  return program_spans.host_ms(record, ("reduce_grads", "adam", "ema"))

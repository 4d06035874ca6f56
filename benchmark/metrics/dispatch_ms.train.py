"""Host ms a step to dispatch an outer step: the port's ``step`` span less
its ``data.wait``, over the window's steps.  At 256 px (``xmc256-train``)
the host blocks on the card's full launch queue inside the step, so there
it reads the device's backlog, not host work."""

from benchmark import program_spans


def read(record):
  step = program_spans.host_ms(record, ("step",))
  if step is None:
    return None
  return step - program_spans.host_ms(record, ("data.wait",))

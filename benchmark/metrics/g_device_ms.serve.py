"""Device ms a request: the union of the card's operations (G's kernels
and the input and image copies) in the traced window over its
requests."""


def read(record):
  if record.kind != "serve" or record.trace is None or not record.work:
    return None
  return 1e3 * record.trace.busy_s / record.work

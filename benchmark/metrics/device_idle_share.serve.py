"""The share of the traced window in which no operation ran on the card:
1 - (the union of the device operations' intervals) / the window."""


def read(record):
  if record.kind != "serve" or record.trace is None:
    return None
  return 100.0 * (1.0 - record.trace.busy_s / record.trace.window_s)

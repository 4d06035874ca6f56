"""All images returned in the window over the window's wall time."""


def read(record):
  if record.kind != "serve" or not record.window_s:
    return None
  return record.images / record.window_s

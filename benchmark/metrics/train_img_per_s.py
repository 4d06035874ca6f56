"""Images of all outer steps completed in the window over the window's
wall time; the window ends on ``torch.cuda.synchronize()``."""


def read(record):
  if record.kind != "train" or not record.window_s:
    return None
  return record.images / record.window_s

"""Mean host ms a step blocked on the prefetcher for its super-batch
(``train.timed_step``'s ``data_seconds``) over the window's steps."""


def read(record):
  stalls = getattr(record, "data_seconds", None)
  if record.kind != "train" or not stalls:
    return None
  return 1e3 * sum(stalls) / len(stalls)

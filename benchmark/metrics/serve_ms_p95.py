"""The 95th percentile (nearest rank) of the latencies of all requests of
the window, each on the host clock from handing the host inputs to the
artifact's callable until the image is on the host."""

import math


def read(record):
  latencies = sorted(getattr(record, "latencies_ms", None) or [])
  if record.kind != "serve" or not latencies:
    return None
  return latencies[math.ceil(0.95 * len(latencies)) - 1]

"""Batches moved to the device ahead of the step (the counterpart of the
JAX package's ``DevicePrefetchIterator``).

A background thread takes batches from a loader's iterator, keeps their
numeric arrays (caption text stays on the host), pins them and, on a CUDA
device, starts their copies with ``non_blocking`` on a side stream and
records an event after them.  Up to ``size`` batches wait in a queue.
`__next__` makes the caller's current stream wait for the batch's event
and marks each tensor as used on that stream (``record_stream``), so the
caching allocator does not hand its memory out again while the step
reads it.  On a CPU device the arrays become tensors as they are: the
caller asked for the CPU.

`get_state` is the loader's state from before the oldest batch that has
not been handed out, so a run resumed from it takes exactly the batches
an uninterrupted one would have.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict

import numpy as np
import torch

def numeric_tensors(batch, device) -> Dict[str, torch.Tensor]:
  """The numeric entries of a batch as tensors on ``device``; tensors (a
  prefetcher's batch) pass as they are, caption text is left out."""
  return {k: v if isinstance(v, torch.Tensor)
          else torch.from_numpy(np.ascontiguousarray(v)).to(device)
          for k, v in batch.items()
          if isinstance(v, torch.Tensor) or np.asarray(v).dtype.kind in "fiub"}


class DevicePrefetcher:
  """Keeps ``size`` batches of ``iterator`` on ``device`` ahead."""

  def __init__(self, iterator, device, size: int = 2):
    self._it = iterator
    self._device = torch.device(device)
    self._size = max(1, size)
    self._state = iterator.get_state()
    self._queue: queue.Queue = queue.Queue(maxsize=self._size)
    self._thread = None
    self._stop = threading.Event()

  # -- the background thread --------------------------------------------

  def _transfer(self, batch) -> Dict[str, Any]:
    tensors = numeric_tensors(batch, "cpu")
    if self._device.type != "cuda":
      return {"tensors": tensors, "event": None}
    pinned = {k: t.pin_memory() for k, t in tensors.items()}
    with torch.cuda.stream(self._stream):
      moved = {k: t.to(self._device, non_blocking=True)
               for k, t in pinned.items()}
      event = torch.cuda.Event()
      event.record(self._stream)
    return {"tensors": moved, "event": event}

  def _put(self, item) -> bool:
    while not self._stop.is_set():
      try:
        self._queue.put(item, timeout=0.1)
        return True
      except queue.Full:
        continue
    return False

  def _run(self) -> None:
    if self._device.type == "cuda":
      self._stream = torch.cuda.Stream(self._device)
    while not self._stop.is_set():
      try:
        batch = next(self._it)
        item = self._transfer(batch)
        item["state"] = self._it.get_state()   # after this batch
      except Exception as e:  # noqa: BLE001 - raised again by the consumer
        self._put({"error": e})
        return
      if not self._put(item):
        return

  def _start(self) -> None:
    if self._thread is None:
      self._stop.clear()
      self._thread = threading.Thread(target=self._run, daemon=True,
                                      name="device-prefetch")
      self._thread.start()

  def _halt(self) -> None:
    if self._thread is not None:
      self._stop.set()
      self._thread.join()
      self._thread = None
    while not self._queue.empty():
      self._queue.get_nowait()

  # -- the consumer -----------------------------------------------------

  def __iter__(self) -> "DevicePrefetcher":
    return self

  def __next__(self) -> Dict[str, torch.Tensor]:
    self._start()
    item = self._queue.get()
    if "error" in item:
      self._thread = None
      raise item["error"]
    if item["event"] is not None:
      stream = torch.cuda.current_stream(self._device)
      stream.wait_event(item["event"])
      for t in item["tensors"].values():
        t.record_stream(stream)
    self._state = item["state"]
    return item["tensors"]

  def get_state(self) -> Dict[str, Any]:
    return self._state

  def set_state(self, state: Dict[str, Any]) -> None:
    """Drops the buffered batches and restarts the loader at ``state``."""
    self._halt()
    self._it.set_state(state)
    self._state = self._it.get_state()

  def close(self) -> None:
    """Stops the thread and the loader's workers."""
    self._halt()
    self._it.close()

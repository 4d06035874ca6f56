"""Experiment services: the checkpoint poller of the evaluation job and
the ``scores.csv`` writer (the JAX package's ``utils/task_manager.py``).
In a service of several processes only process 0 polls and writes
(`evaluate._synchronized_steps`).

`TaskManager.unevaluated_checkpoints` polls the training job's checkpoint
directory, yields the steps not evaluated yet and returns on timeout or
once the ``TRAIN_DONE`` marker is there and everything is evaluated.
`TaskManagerWithCsvResults` skips the steps already in ``scores.csv`` and
appends a row per evaluated step.  A checkpoint file appears whole, by an
atomic rename locally or when its one upload ends on a store
(`utils.checkpoint`), so every listed step is complete.
"""

from __future__ import annotations

import csv
import io
import logging
import time
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Set)

from xmcgan_image_generation_tpu_torch.utils import checkpoint
from xmcgan_image_generation_tpu_torch.utils import fileio

log = logging.getLogger("xmcgan_torch")

TRAIN_DONE_MARKER = "TRAIN_DONE"


class TaskManager:
  """Tracks a training task through its checkpoint directory."""

  def __init__(self, checkpoint_dir: str):
    self.checkpoint_dir = fileio.abspath(checkpoint_dir)

  def mark_training_done(self) -> None:
    fileio.atomic_write(
        fileio.join(self.checkpoint_dir, TRAIN_DONE_MARKER),
        time.strftime("%Y-%m-%d %H:%M:%S"))

  def is_training_done(self) -> bool:
    return fileio.exists(fileio.join(self.checkpoint_dir,
                                     TRAIN_DONE_MARKER))

  def _list_steps(self) -> List[int]:
    return checkpoint.list_steps(self.checkpoint_dir)

  def unevaluated_checkpoints(self, timeout: float = 3600 * 8,
                              poll_interval: float = 5.0,
                              poll_callback: Optional[Callable[[], None]]
                              = None) -> Iterator[int]:
    """Yields the steps of checkpoints not evaluated yet as they appear,
    polling every ``poll_interval`` seconds; returns when training is
    marked done and all is evaluated, or when no new checkpoint appeared
    for ``timeout`` seconds.  ``poll_callback`` is called once each idle
    poll, before the sleep: the hook through which the multi-process
    service sends its heartbeats while it waits."""
    log.info("Looking for checkpoints in %s", self.checkpoint_dir)
    evaluated: Set[int] = set(self._evaluated_steps())
    last_eval = time.time()
    while True:
      done = self.is_training_done()  # before listing: no step is missed
      unevaluated = [s for s in self._list_steps() if s not in evaluated]
      for step in unevaluated:
        evaluated.add(step)
        yield step
        last_eval = time.time()
      if done and not unevaluated:
        log.info("Training is done; exiting checkpoint polling.")
        return
      if time.time() - last_eval > timeout:
        log.info("Timeout (%ds) waiting for new checkpoints; exiting.",
                 timeout)
        return
      if not unevaluated:
        if poll_callback is not None:
          poll_callback()
        time.sleep(poll_interval)

  def _evaluated_steps(self) -> Iterable[int]:
    return []


class TaskManagerWithCsvResults(TaskManager):
  """A `TaskManager` that keeps evaluation results in ``scores.csv``."""

  def __init__(self, checkpoint_dir: str,
               score_file: Optional[str] = None):
    super().__init__(checkpoint_dir)
    self._score_file = score_file or fileio.join(self.checkpoint_dir,
                                                 "scores.csv")

  def _evaluated_steps(self) -> List[int]:
    if not fileio.exists(self._score_file):
      return []
    with fileio.open(self._score_file) as f:
      return [int(row["step"]) for row in csv.DictReader(f)]

  def add_eval_result(self, step: int, result: Dict[str, float],
                      default_value: float = -1.0) -> None:
    result = {k: float(v) for k, v in result.items()}
    exists = fileio.exists(self._score_file)
    fieldnames = ["step"] + sorted(result)
    fileio.makedirs(fileio.dirname(self._score_file))
    buf = io.StringIO()
    writer = csv.DictWriter(buf, fieldnames=fieldnames,
                            restval=default_value, extrasaction="ignore")
    if not exists:
      writer.writeheader()
    writer.writerow({"step": int(step), **result})
    fileio.append_text(self._score_file, buf.getvalue())

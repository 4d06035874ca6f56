"""SIGTERM -> an agreed stop step -> a checkpoint (the JAX package's
``utils/preemption.py``).

A preempted machine gets SIGTERM and a grace window.  Instead of losing
the work since the last periodic checkpoint, the training loop saves at
the preemption point and returns without ``TRAIN_DONE``, so the restarted
job resumes where it stopped (parameters and data position) and the
evaluation service keeps polling.

The stop step is agreed through the workdir, as the JAX package does for
its processes, so that a multi-process run can reuse the guard:

  1. A signaled process computes ``target = current_step + margin`` and
     writes it to ``PREEMPT_STOP`` exclusively: the first writer wins, and
     every process reads one target.
  2. Every process reads the marker each step and stops when ``step >=
     target``; ``margin`` covers the processes' skew.
  3. A marker whose target precedes this run's ``initial_step`` is stale
     (left by the previous preemption) and is removed by process 0.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

from xmcgan_image_generation_tpu_torch.utils import fileio

log = logging.getLogger("xmcgan_torch")

MARKER = "PREEMPT_STOP"


class PreemptionGuard:
  """Coordinates a graceful, step-aligned stop.

  Usage::

      guard = PreemptionGuard(workdir, initial_step)
      guard.install()
      try:
        for step in ...:
          ...
          if guard.should_stop(step):
            save_checkpoint(step); break
      finally:
        guard.uninstall()
  """

  def __init__(self, workdir: str, initial_step: int, *, margin: int = 2,
               process_index: int = 0):
    self._path = fileio.join(workdir, MARKER)
    self._initial_step = initial_step
    self._margin = margin
    self._signaled = threading.Event()
    self._old_handler = None
    self._installed = False
    self._process_index = process_index

  # -- signal plumbing ----------------------------------------------------

  def install(self) -> None:
    """Registers the SIGTERM handler (on the main thread only; elsewhere
    `request_stop` and the marker still work) and removes a stale marker
    (process 0)."""
    if self._process_index == 0:
      stale = self._read_target()
      if stale is not None and stale < self._initial_step:
        try:
          fileio.remove(self._path)
          log.info("Removed stale %s (target %d < initial step %d)",
                   MARKER, stale, self._initial_step)
        except OSError:
          pass
    if threading.current_thread() is threading.main_thread():
      self._old_handler = signal.signal(signal.SIGTERM, self._on_signal)
      self._installed = True

  def uninstall(self) -> None:
    if self._installed:
      signal.signal(signal.SIGTERM, self._old_handler)
      self._installed = False

  def _on_signal(self, signum, frame) -> None:  # noqa: ARG002
    # Only set a flag: the loop does the I/O.
    self._signaled.set()

  def request_stop(self) -> None:
    """Preemption without a signal (tests, orchestrators)."""
    self._signaled.set()

  # -- marker protocol ----------------------------------------------------

  def _read_target(self) -> Optional[int]:
    try:
      return int(fileio.read_text(self._path).strip())
    except (OSError, ValueError):
      return None

  def _write_target(self, step: int, _retry: bool = True) -> None:
    target = step + self._margin
    try:
      won = fileio.create_exclusive(self._path, str(target))
    except OSError as e:
      # A transient error must not stop training: try again next step.
      log.warning("Preemption marker write failed (%s); retrying next "
                  "step", e)
      self._signaled.set()
      return
    if not won:
      # A live marker: a peer won.  A stale one would swallow this signal:
      # remove it and try once more.
      existing = self._read_target()
      if (_retry and existing is not None
          and existing < self._initial_step):
        try:
          fileio.remove(self._path)
        except OSError:
          pass
        self._write_target(step, _retry=False)
      return
    log.info("Preemption signal at step %d: stop agreed at step %d",
             step, target)

  def cleanup(self) -> None:
    """Removes any marker after a normal completion (process 0 only): a
    signal within ``margin`` of the last step leaves a live target that
    would stop the next, extending run at once."""
    if self._process_index != 0:
      return
    try:
      fileio.remove(self._path)
      log.info("Removed %s after normal completion", MARKER)
    except OSError:
      pass

  def should_stop(self, step: int) -> bool:
    """True when this step is the agreed preemption-save point."""
    if self._signaled.is_set():
      self._signaled.clear()
      self._write_target(step)
    target = self._read_target()
    if target is None or target < self._initial_step:
      return False
    return step >= target

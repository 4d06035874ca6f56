"""The port's preemption guard against the JAX package's, and a SIGTERM to
a CPU training process of the port.

The guard: the same sequences of signals, steps, installs and cleanups
drive the port's and the JAX package's `PreemptionGuard` in two workdirs,
and every decision and the marker files must agree; each package honours
the other's marker.  The process: ``python -m
xmcgan_image_generation_tpu_torch.main --mode=train`` on the CPU gets a
SIGTERM after its first step, checkpoints at the agreed step, leaves
``PREEMPT_STOP`` and no ``TRAIN_DONE``, and a rerun resumes and finishes
with the losses of an uninterrupted run, step for step (one thread, so
the CPU arithmetic is the same in every process): it took the batches
the uninterrupted run took.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from xmcgan_image_generation_tpu.utils import preemption as j_preemption
from xmcgan_image_generation_tpu_torch.utils import checkpoint
from xmcgan_image_generation_tpu_torch.utils import preemption

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARKER = preemption.MARKER

# Each scenario: (marker left before the run or None, initial step, margin,
# process index, actions).  An action is ("signal",), ("step", n),
# ("install",), ("cleanup",); every "step" records should_stop's answer.
SCENARIOS = {
    "no_signal": (None, 1, 2, 0, [("step", s) for s in range(1, 5)]),
    "margin_later": (None, 1, 2, 0, [("signal",), ("step", 10),
                                     ("step", 11), ("step", 12),
                                     ("step", 13)]),
    "margin_3": (None, 4, 3, 0, [("step", 4), ("signal",), ("step", 5),
                                 ("step", 7), ("step", 8)]),
    "stale_removed": ("7", 8, 2, 0, [("install",), ("step", 8),
                                     ("step", 9)]),
    "stale_kept_by_process_1": ("7", 8, 2, 1, [("install",), ("step", 9)]),
    "stale_not_swallowing": ("3", 8, 2, 1, [("signal",), ("step", 10),
                                            ("step", 12)]),
    "cleanup_after_finish": (None, 1, 2, 0, [("signal",), ("step", 10),
                                             ("cleanup",)]),
    "cleanup_process_1": (None, 1, 2, 1, [("signal",), ("step", 5),
                                          ("cleanup",)]),
    "live_marker_of_a_peer": ("12", 8, 2, 0, [("install",), ("step", 11),
                                              ("signal",), ("step", 11),
                                              ("step", 12)]),
}


def _play(module, workdir, scenario):
  marker, initial, margin, process, actions = scenario
  if marker is not None:
    with open(os.path.join(workdir, MARKER), "w") as f:
      f.write(marker)
  guard = module.PreemptionGuard(workdir, initial, margin=margin,
                                 process_index=process)
  answers = []
  for action in actions:
    if action[0] == "signal":
      guard.request_stop()
    elif action[0] == "install":
      guard.install()
      guard.uninstall()
    elif action[0] == "cleanup":
      guard.cleanup()
    else:
      answers.append(guard.should_stop(action[1]))
  path = os.path.join(workdir, MARKER)
  content = open(path).read() if os.path.exists(path) else None
  return answers, content, sorted(os.listdir(workdir))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_guard_decides_as_jax(name, tmp_path):
  ours, theirs = tmp_path / "ours", tmp_path / "theirs"
  ours.mkdir()
  theirs.mkdir()
  got = _play(preemption, str(ours), SCENARIOS[name])
  want = _play(j_preemption, str(theirs), SCENARIOS[name])
  assert got == want


def test_each_package_honours_the_others_marker(tmp_path):
  for writer, reader in ((preemption, j_preemption),
                         (j_preemption, preemption)):
    workdir = tmp_path / writer.__name__
    workdir.mkdir()
    first = writer.PreemptionGuard(str(workdir), 1, margin=2)
    first.request_stop()
    assert not first.should_stop(10)
    second = reader.PreemptionGuard(str(workdir), 1, margin=2,
                                    process_index=1)
    assert not second.should_stop(11)
    assert second.should_stop(12)
    assert (workdir / MARKER).read_text() == "12"


def _env():
  env = dict(os.environ)
  env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
  env["OMP_NUM_THREADS"] = "1"
  env["CUDA_VISIBLE_DEVICES"] = ""
  return env


def _command(workdir, steps):
  return [sys.executable, "-m", "xmcgan_image_generation_tpu_torch.main",
          f"--workdir={workdir}", "--config=test", "--device=cpu",
          "--mode=train", f"--num_train_steps={steps}",
          # A cadence it never reaches: a checkpoint before the last step
          # is the preemption's.
          "--config.checkpoint_every_steps=100000",
          "--config.eval_every_steps=100000"]


def _losses(workdir):
  with open(os.path.join(workdir, "metrics.jsonl")) as f:
    return [{k: v for k, v in json.loads(line).items()
             if "seconds" not in k} for line in f]


def test_sigterm_checkpoints_and_resumes(tmp_path):
  steps = 24
  workdir = str(tmp_path / "preempted")
  metrics = os.path.join(workdir, "metrics.jsonl")
  proc = subprocess.Popen(_command(workdir, steps), env=_env(), cwd=ROOT,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
  try:
    deadline = time.time() + 300
    while not (os.path.exists(metrics) and open(metrics).read().strip()):
      assert proc.poll() is None and time.time() < deadline, \
          "training ended or stalled before its first step"
      time.sleep(0.02)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=300)
  finally:
    if proc.poll() is None:
      proc.kill()
      proc.communicate()
  assert proc.returncode == 0, out[-3000:]

  ckpt_dir = checkpoint.checkpoints_dir(workdir)
  saved = checkpoint.list_steps(ckpt_dir)
  marker = os.path.join(workdir, MARKER)
  assert len(saved) == 1 and saved[0] < steps, (saved, out[-3000:])
  assert int(open(marker).read()) == saved[0]   # the agreed step
  assert not os.path.exists(os.path.join(ckpt_dir, "TRAIN_DONE"))
  payload = torch.load(checkpoint.CheckpointManager(ckpt_dir).path(saved[0]),
                       weights_only=True)
  assert payload["step"] == saved[0]
  # Super-batch 0 went to initialization, as in the JAX loop; step k took
  # super-batch k, so the next is saved[0] + 1.
  assert payload["data_iter"]["position"] == saved[0] + 1
  assert [m["step"] for m in _losses(workdir)] == list(range(1, saved[0] + 1))

  rerun = subprocess.run(_command(workdir, steps), env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=False)
  assert rerun.returncode == 0, rerun.stderr[-3000:]
  assert os.path.exists(os.path.join(ckpt_dir, "TRAIN_DONE"))
  assert checkpoint.list_steps(ckpt_dir)[-1] == steps
  assert not os.path.exists(marker)   # stale: removed by the rerun

  whole = str(tmp_path / "whole")
  plain = subprocess.run(_command(whole, steps), env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=False)
  assert plain.returncode == 0, plain.stderr[-3000:]
  assert _losses(workdir) == _losses(whole)

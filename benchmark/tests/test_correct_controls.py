"""The comparison that decides ``correct`` fails what it has to fail.

Each cell's run is driven on the CPU at a small size, past the harness's
look for a card, with the cell's own limits: sound, it is correct; with
the control (the reference in float8 in the program's place) or a fault
planted under the timed path it is not.  The faults: a training step
that leaves its state as it was; a training step that drops half of each
batch and takes its means over the rest; a served image altered where it
is produced.  The sizes are small and the program runs in float32, so
that its own gaps are far inside the limits that its bfloat16 runs at the
cells' sizes set.
"""

import copy
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import cells, compare, faults, run
from benchmark.reference import layers

TRAIN = ("xmc128-train", "xmc256-train")
SERVE = ("xmc128-serve-b1",)
SEED = 2 ** 31 + 777


def small(cell):
  workload = cells.workload(cell)
  config = copy.deepcopy(cells.config(workload["config"]))
  big = config["config"]["image_size"] == 256
  config["config"].update(image_size=64 if big else 32,
                          batch_size=8 if big else 4, df_dim=16, gf_dim=16,
                          z_dim=8, pretrained_image_contrastive=not big,
                          dtype="float32")
  mix = dict(cells.mix(workload["traffic"]))
  if mix["kind"] == "serve":
    mix.update(pool=6, warmup=2, calibration_batch=4)
  return {"workload": workload, "config": config, "mix": mix}


def execute(cell, files=None):
  torch.manual_seed(0)
  return run.execute(cell, SEED, 0.3, False, "cpu", time.perf_counter(),
                     files or small(cell))


def context(cell):
  files = small(cell)
  return run.Context(cell, files["config"], files["mix"], SEED, 0.0, False,
                     "cpu", time.perf_counter()), files


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_run_is_correct(cell):
  result = execute(cell)
  assert result["correct"], result["checks"]
  assert list(result) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
  assert result["attempted"] >= 1


@pytest.mark.parametrize("cell", TRAIN)
def test_control_fails_training(cell):
  ctx, files = context(cell)
  driver = cells.driver("train")
  control = driver.reference(ctx, rounding=layers.fp8_rounding)
  numbers = compare.train_numbers(control, driver.reference(ctx))
  checks = compare.judge(numbers, files["workload"]["limits"])
  assert not compare.passed(checks), checks


def test_control_fails_serving():
  cell = SERVE[0]
  ctx, files = context(cell)
  driver = cells.driver("serve")
  indices = list(range(ctx.mix["pool"]))
  control = driver.reference_images(ctx, indices, layers.fp8_rounding)
  numbers = driver.check(ctx, [control[i] for i in indices])
  checks = compare.judge(numbers, files["workload"]["limits"])
  assert not compare.passed(checks), checks


@pytest.mark.parametrize("fault", sorted(faults.TRAINING))
@pytest.mark.parametrize("cell", TRAIN)
def test_training_fault_fails(cell, fault, monkeypatch):
  from xmcgan_image_generation_tpu_torch import train as train_lib

  monkeypatch.setattr(train_lib, "train_step",
                      faults.TRAINING[fault](train_lib.train_step))
  result = execute(cell)
  assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_unchanged_state_reads_one(cell, monkeypatch):
  """A state left unchanged reads 1 on every number of the state, by the
  worst leaf: the upper reading of ``grad``, ``ema``, ``bn`` and ``bn1``."""
  from xmcgan_image_generation_tpu_torch import train as train_lib

  monkeypatch.setattr(train_lib, "train_step",
                      faults.unchanged_state(train_lib.train_step))
  ctx, _ = context(cell)
  driver = cells.driver("train")
  _, produced = driver.run(ctx)
  numbers = compare.train_numbers(produced, driver.reference(ctx))
  for name in ("grad", "ema", "bn", "bn1"):
    assert numbers[name] == pytest.approx(1.0), (name, numbers)
  assert numbers["change_median"] > 0.5, numbers


def test_altered_image_fails(monkeypatch):
  from xmcgan_image_generation_tpu_torch.utils import serving

  monkeypatch.setattr(serving, "load_exported",
                      faults.altered_image(serving.load_exported))
  result = execute(SERVE[0])
  assert not result["correct"], result["checks"]


def test_no_card_no_line():
  out = subprocess.run(
      [sys.executable, str(cells.HERE / "run.py"), "--workload",
       "xmc128-train", "--seed", "1", "--seconds", "1", "--trace", "0"],
      capture_output=True, text=True, timeout=300,
      env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
  assert out.returncode != 0 and out.stdout.strip() == ""


def test_jax_is_found_by_top_level_name(monkeypatch):
  assert run.forbidden_modules() == []
  monkeypatch.setitem(sys.modules, "xmcgan_image_generation_tpu_torch_x",
                      sys)
  assert run.forbidden_modules() == []
  monkeypatch.setitem(sys.modules, "jax.numpy", sys)
  assert run.forbidden_modules() == ["jax"]


def test_checks_close_the_line(capsys, monkeypatch):
  result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
            "device": {}, "checks": {"loss": {"value": 0.5, "limit": 1.0}}}
  monkeypatch.setattr(run.torch.cuda, "is_available", lambda: True)
  monkeypatch.setattr(run.torch.cuda, "device_count", lambda: 1)
  monkeypatch.setattr(run, "execute", lambda *a, **k: dict(result))
  assert run.main(["--workload", "xmc128-train", "--seed", "3",
                   "--seconds", "1", "--trace", "0"]) == 0
  out, err = capsys.readouterr()
  line = json.loads(out.strip().splitlines()[-1])
  assert list(line)[-1] == "checks"
  assert err.strip().splitlines()[-1] == "check loss: 0.5 (limit 1.0)"

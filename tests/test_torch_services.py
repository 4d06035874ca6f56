"""The training loop's services against the JAX package's: metric means,
progress reports, hyperparameters, TensorBoard events, the GAN-algorithm
registry, the profiler hook, the configuration files and ``--config``,
and the loader's transfer of a batch.

Tolerances: the interval means are float32 sums on the device divided on
the host, against float64 means of the per-step float32 values: 1e-6
relative.  Event records and configuration values are compared exactly.
"""

import json
import os
import struct
import threading
import multiprocessing

import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu import train as j_train
from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.configs import coco_xmc_256 as j_coco_256
from xmcgan_image_generation_tpu.engine import registry as j_registry
from xmcgan_image_generation_tpu.utils import metric_writer as j_mw
from xmcgan_image_generation_tpu.utils import tb_writer as j_tb
from xmcgan_image_generation_tpu_torch import main as main_lib
from xmcgan_image_generation_tpu_torch import train as train_lib
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.configs import coco_xmc_256
from xmcgan_image_generation_tpu_torch.data import pipeline
from xmcgan_image_generation_tpu_torch.data import png
from xmcgan_image_generation_tpu_torch.data import records
from xmcgan_image_generation_tpu_torch.engine import registry
from xmcgan_image_generation_tpu_torch.engine.step import train_step
from xmcgan_image_generation_tpu_torch.utils import metric_writer
from xmcgan_image_generation_tpu_torch.utils import tb_writer

torch.set_num_threads(1)

LOSSES = {"d_loss", "g_loss", "c_loss_d", "c_loss_g", "c_loss_g_pretrained"}
PROGRESS = {"steps_per_sec", "perf/images_per_sec"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _loop_config(module, **overrides):
  """The test config, 3 steps, a batch of 8 (the JAX loop's 8 CPU
  devices), sampling and checkpoints at the last step only."""
  config = module.get_test_config()
  for k, v in dict(num_train_steps=3, batch_size=8, eval_every_steps=100,
                   checkpoint_every_steps=100, **overrides).items():
    setattr(config, k, v)
  return config


def _lines(workdir):
  with open(os.path.join(workdir, "metrics.jsonl")) as f:
    return [json.loads(line) for line in f]


def _events(workdir):
  """``[(step, tag, value)]`` of the scalar events of the workdir's event
  file, its TFRecord framing and CRCs checked."""
  (name,) = [n for n in os.listdir(workdir) if n.startswith("events.out")]
  with open(os.path.join(workdir, name), "rb") as f:
    data = f.read()
  out, pos, first = [], 0, True
  while pos < len(data):
    header = data[pos:pos + 8]
    (length,) = struct.unpack("<Q", header)
    (crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
    record = data[pos + 12:pos + 12 + length]
    (data_crc,) = struct.unpack("<I", data[pos + 12 + length:
                                           pos + 16 + length])
    assert crc == records.masked_crc(header)
    assert data_crc == records.masked_crc(record)
    pos += 16 + length
    fields = {f: v for f, _, v, _ in records._iter_fields(record)}
    if first:
      assert fields[3] == b"brain.Event:2"
      first = False
      continue
    for f, _, value, _ in records._iter_fields(fields[5]):
      tag = simple = None
      for vf, _, v, _ in records._iter_fields(value):
        if vf == 1:
          tag = v.decode()
        elif vf == 2:
          (simple,) = struct.unpack("<f", v)
      if simple is not None:
        out.append((fields[2], tag, simple))
  return out


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
  """The JAX loop and the port's over 3 steps with
  ``log_loss_every_steps=3``, and the port's again logging every step."""
  root = tmp_path_factory.mktemp("loops")
  j_config = _loop_config(j_coco_xmc, log_loss_every_steps=3,
                          log_perf=False)
  j_train.train(j_config, str(root / "jax"))
  train_lib.train(_loop_config(coco_xmc, log_loss_every_steps=3),
                  str(root / "port"), "cpu")
  train_lib.train(_loop_config(coco_xmc, log_loss_every_steps=1),
                  str(root / "every"), "cpu")
  return {k: str(root / k) for k in ("jax", "port", "every")}


def test_metric_lines_at_the_jax_loops_steps(loops):
  got, want = _lines(loops["port"]), _lines(loops["jax"])
  assert [(m["step"], set(m) - {"step"}) for m in want] == [
      (3, PROGRESS), (3, LOSSES)]
  assert [(m["step"], set(m) - {"step"}) for m in got] == [
      (3, PROGRESS), (3, LOSSES | {"seconds", "data_seconds"})]


def test_metric_line_holds_the_interval_means(loops):
  (line,) = [m for m in _lines(loops["port"]) if "d_loss" in m]
  steps = [m for m in _lines(loops["every"]) if "d_loss" in m]
  assert [m["step"] for m in steps] == [1, 2, 3]
  for k in LOSSES:
    np.testing.assert_allclose(line[k], np.mean([m[k] for m in steps]),
                               rtol=1e-6, atol=1e-7, err_msg=k)
  assert line["seconds"] >= line["data_seconds"] >= 0


def test_hparams_are_the_jax_loops(loops):
  with open(os.path.join(loops["jax"], "hparams.json")) as f:
    want = json.load(f)
  with open(os.path.join(loops["port"], "hparams.json")) as f:
    got = json.load(f)
  want.pop("log_perf")   # set on the JAX side only, to skip its cost model
  want["log_loss_every_steps"] = got["log_loss_every_steps"]
  assert got == want


def test_event_files_hold_the_metric_lines(loops):
  for name in ("jax", "port"):
    events = _events(loops[name])
    want = [(m["step"], k, np.float32(v)) for m in _lines(loops[name])
            for k, v in m.items() if k != "step"]
    assert [(s, t, np.float32(v)) for s, t, v in events] == want


def test_scalar_and_image_events_match_jax_bytes():
  scalars = {"d_loss": 1.25, "perf/images_per_sec": 33.5, "g_lr": 1e-4}
  assert (tb_writer._event(7, tb_writer.scalar_summary(scalars), 1.5)
          == j_tb._event(7, j_tb.scalar_summary(scalars), 1.5))
  image = np.random.default_rng(0).uniform(0, 1, (6, 5, 3))
  got, want = tb_writer.encode_png(image), j_tb.encode_png(image)
  np.testing.assert_array_equal(png.decode(got), png.decode(want))
  assert (tb_writer.image_summary("grid", got, 6, 5)
          == j_tb.image_summary("grid", got, 6, 5))


def test_event_file_framing_matches_jax(tmp_path):
  got = tb_writer.EventFileWriter(str(tmp_path / "port"))
  want = j_tb.EventFileWriter(str(tmp_path / "jax"))
  for w in (got, want):
    w.write_scalars(3, {"a": 0.5, "b": -2.0})
    w.close()
  with open(got.path, "rb") as f:
    port_bytes = f.read()
  with open(want.path, "rb") as f:
    jax_bytes = f.read()
  # Equal but for the two wall times (8 bytes each, after a 1-byte tag).
  assert len(port_bytes) == len(jax_bytes)
  assert _events(str(tmp_path / "port")) == _events(str(tmp_path / "jax"))


@pytest.mark.parametrize("values", [
    [{"a": 1.0, "b": 2.0}, {"a": 3.0, "b": -1.0}, {"a": 0.5, "b": 0.25}],
    [{"a": 7.0}]], ids=["three", "one"])
def test_metric_accumulator_matches_jax(values):
  got, want = metric_writer.MetricAccumulator(), j_mw.MetricAccumulator()
  for step in values:
    got.update({k: torch.tensor(v) for k, v in step.items()})
    want.update({k: np.float32(v) for k, v in step.items()})
  assert got.compute_and_reset() == pytest.approx(want.compute_and_reset())
  assert got.compute_and_reset() == want.compute_and_reset() == {}


class _Writer:

  def __init__(self):
    self.lines = []

  def write_scalars(self, step, scalars):
    self.lines.append((step, sorted(scalars)))


def test_report_progress_matches_jax():
  got, want = _Writer(), _Writer()
  port = metric_writer.ReportProgress(every_steps=2, num_train_steps=5,
                                      writer=got, images_per_step=4)
  ref = j_mw.ReportProgress(every_steps=2, num_train_steps=5, writer=want,
                            images_per_step=4)
  for step in range(1, 6):
    port(step)
    ref(step)
  assert got.lines == want.lines == [(2, sorted(PROGRESS)),
                                     (4, sorted(PROGRESS))]


@pytest.mark.parametrize("name", ["other", "xmc_gan"])
def test_unknown_model_name_raises(name):
  config = coco_xmc.get_test_config()
  config.model_name = name
  j_config = j_coco_xmc.get_test_config()
  j_config.model_name = name
  with pytest.raises(NotImplementedError):
    j_registry.get_gan_algorithm(j_config)
  with pytest.raises(NotImplementedError, match=name):
    registry.get_gan_algorithm(config)
  with pytest.raises(NotImplementedError):
    train_lib.setup(config, torch.device("cpu"))
  with pytest.raises(NotImplementedError):
    train_step(None, {}, config, {})


def test_profile_writes_a_trace(tmp_path):
  """``profile=True`` captures steps 10-15 with torch.profiler."""
  config = coco_xmc.get_test_config()
  config.update(num_train_steps=16, profile=True, eval_every_steps=100,
                checkpoint_every_steps=100, log_loss_every_steps=100)
  train_lib.train(config, str(tmp_path), "cpu")
  directory = tmp_path / "plugins" / "profile"
  (trace,) = [p for p in directory.iterdir()
              if p.name.endswith(".pt.trace.json")]
  events = json.loads(trace.read_text())["traceEvents"]
  assert any(e.get("name", "").startswith("aten::") for e in events)


@pytest.mark.parametrize("variant", ["", "test"])
def test_256px_config_file_is_the_jax_packages(variant):
  got = (coco_xmc_256.get_config(variant) if variant
         else coco_xmc_256.get_config())
  want = (j_coco_256.get_config(variant) if variant
          else j_coco_256.get_config()).to_dict()
  assert dict(got) == want


def test_256px_test_config_is_the_jax_packages():
  assert dict(coco_xmc_256.get_test_config()) == (
      j_coco_256.get_test_config().to_dict())


def test_config_flag_reads_a_config_file(tmp_path):
  path = os.path.join(ROOT, "xmcgan_image_generation_tpu_torch", "configs",
                      "coco_xmc_256.py")
  assert main_lib.load_config(path) == coco_xmc_256.get_config()
  assert main_lib.load_config(f"{path}:test") == coco_xmc_256.get_config(
      "test")
  assert main_lib.load_config("test") == coco_xmc.get_test_config()
  with pytest.raises(ValueError, match="no config file"):
    main_lib.load_config(str(tmp_path / "missing.py"))


def test_cli_trains_the_256px_file_on_the_cpu(tmp_path):
  path = os.path.join("xmcgan_image_generation_tpu_torch", "configs",
                      "coco_xmc_256.py")
  cwd = os.getcwd()
  os.chdir(ROOT)
  try:
    main_lib.main([f"--config={path}:test", "--device=cpu",
                   f"--workdir={tmp_path}",
                   "--config.grad_accum_steps=2"])
  finally:
    os.chdir(cwd)
  steps = [m["step"] for m in _lines(str(tmp_path)) if "d_loss" in m]
  assert steps == [1, 2]
  with open(tmp_path / "hparams.json") as f:
    assert json.load(f)["grad_accum_steps"] == 2


def _send(conn, batch):
  pipeline._send_batch(conn, batch)


def test_loader_transfer_of_a_large_batch():
  """A batch of several read chunks crosses the pipe whole."""
  rng = np.random.default_rng(0)
  batch = {"image": rng.integers(0, 256, (12, 300, 301, 3), dtype=np.uint8),
           "z": rng.standard_normal((12, 13)).astype(np.float32)}
  ours, theirs = multiprocessing.Pipe()
  sender = threading.Thread(target=_send, args=(theirs, batch))
  sender.start()
  kind, size = ours.recv()
  got = pipeline._recv_batch(ours, size)
  sender.join(timeout=60)
  assert not sender.is_alive()
  assert kind == "batch" and size > 2 * pipeline._CHUNK
  for k, v in batch.items():
    np.testing.assert_array_equal(got[k], v)
  ours.close()
  theirs.close()

"""The port's workdir seam (`utils/fileio.py`) and every workdir service on
a store, on the CPU.

* The fault: a ``memory://`` workdir given to `train.train` lands in the
  memory filesystem, and nothing lands in a local ``memory:`` directory
  (before the seam, ``os.makedirs`` made ``./memory:/...`` and every
  file went there), the profiler's trace included; an unknown scheme
  raises before any step.
* The JAX package's primitive tests (``tests/test_fileio.py``) on the
  port's seam, over a local directory and ``memory://``.
* The services through real gcsfs against ``tests/fake_gcs.py`` (wired in
  as ``tests/test_gcs_contract.py`` does, with GCS's resumable uploads
  added: gcsfs takes them for an object above its 5 MiB block, and a
  checkpoint is one): the preemption arbiter, the task manager's poll
  under listing lag, ``scores.csv``, ``TRAIN_DONE``, a checkpoint bit for
  bit against a local save, ``--mode=train``, ``test``, ``generate`` and
  ``export`` as one chain on one ``gs://`` workdir (the ``.pt2`` read
  back from the store serves bit for bit as a local export of the same
  checkpoint), a save that fails partway (a part upload or the
  serialization) publishing no checkpoint, and two processes of one run (``torchrun``'s environment,
  gloo) that reach the endpoint through ``STORAGE_EMULATOR_HOST``, write
  both loader states, resume from them and end bit for bit where an
  uninterrupted local run ends.
"""

import csv
import gc
import io
import json
import os
import pathlib
import subprocess
import sys
import threading
import urllib.parse
import uuid

import fsspec
import gcsfs
import numpy as np
import pytest
import torch

import _torch_dist as td
import fake_gcs
from xmcgan_image_generation_tpu_torch import main as main_lib
from xmcgan_image_generation_tpu_torch import train as train_lib
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.utils import checkpoint
from xmcgan_image_generation_tpu_torch.utils import fileio
from xmcgan_image_generation_tpu_torch.utils import serving
from xmcgan_image_generation_tpu_torch.utils.preemption import (
    MARKER,
    PreemptionGuard,
)
from xmcgan_image_generation_tpu_torch.utils.task_manager import (
    TaskManager,
    TaskManagerWithCsvResults,
)

torch.set_num_threads(1)

ROOT = str(pathlib.Path(__file__).resolve().parents[1])


def _memory_files(prefix):
  """``{relative path: size}`` of every file under ``memory://prefix``."""
  fs = fsspec.filesystem("memory")
  return {p[len(prefix) + 2:]: fs.size(p) for p in fs.find(f"/{prefix}")}


# ---------------------------------------------------------------------------
# The fault: a remote workdir landed on the local disk.
# ---------------------------------------------------------------------------


def test_memory_workdir_lands_in_memory(tmp_path, monkeypatch):
  monkeypatch.chdir(tmp_path)
  prefix = f"train-{uuid.uuid4().hex[:8]}"
  config = coco_xmc.get_test_config()
  config.num_train_steps = 1
  state = train_lib.train(config, f"memory://{prefix}", device="cpu")
  files = _memory_files(prefix)
  if files:
    fsspec.filesystem("memory").rm(f"/{prefix}", recursive=True)
  assert state.step == 1
  assert {"checkpoints/checkpoint_1.pt", "checkpoints/TRAIN_DONE",
          "metrics.jsonl", "hparams.json", "checkpoints.jsonl",
          "images/ema_generated_image_00000001.png"} <= set(files)
  assert any(name.startswith("events.out.tfevents.") for name in files)
  assert os.listdir(tmp_path) == []      # no ./memory: directory


def test_memory_workdir_takes_the_profiler_trace(tmp_path, monkeypatch):
  """``profile=True`` on a store: the trace of steps 10-15 lands there."""
  monkeypatch.chdir(tmp_path)
  prefix = f"profile-{uuid.uuid4().hex[:8]}"
  config = coco_xmc.get_test_config()
  config.update(num_train_steps=16, profile=True, eval_every_steps=100,
                checkpoint_every_steps=100, log_loss_every_steps=100)
  train_lib.train(config, f"memory://{prefix}", device="cpu")
  fs = fsspec.filesystem("memory")
  try:
    (trace,) = [name for name in _memory_files(prefix)
                if name.startswith("plugins/profile/")
                and name.endswith(".pt.trace.json")]
    events = json.loads(fs.cat_file(f"/{prefix}/{trace}"))["traceEvents"]
  finally:
    fs.rm(f"/{prefix}", recursive=True)
  assert any(e.get("name", "").startswith("aten::") for e in events)
  assert os.listdir(tmp_path) == []


def test_unknown_scheme_raises_before_a_step(tmp_path, monkeypatch):
  monkeypatch.chdir(tmp_path)
  config = coco_xmc.get_test_config()
  config.num_train_steps = 1
  with pytest.raises(ValueError, match="nosuch"):
    train_lib.train(config, "nosuch://bucket/run", device="cpu")
  assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# The seam's primitives (the JAX package's tests/test_fileio.py).
# ---------------------------------------------------------------------------


@pytest.fixture
def mem_dir():
  """A fresh memory:// prefix, removed afterwards (the memory
  filesystem's store is global to the process)."""
  base = f"memory://fileio-{uuid.uuid4().hex[:12]}"
  yield base
  try:
    fileio.rmtree(base)
  except FileNotFoundError:
    pass


@pytest.fixture(params=["posix", "memory"])
def any_dir(request, tmp_path, mem_dir):
  return str(tmp_path) if request.param == "posix" else mem_dir


def test_scheme_split():
  assert fileio.split_scheme("gs://b/k/x.txt") == ("gs", "b/k/x.txt")
  assert fileio.split_scheme("/local/path") == (None, "/local/path")
  assert fileio.is_remote("memory://a") and not fileio.is_remote("rel/p")
  assert fileio.abspath("gs://b/run") == "gs://b/run"
  assert fileio.join("gs://b/run", "checkpoints") == "gs://b/run/checkpoints"
  assert fileio.basename("gs://b/run/") == "run"
  assert fileio.dirname("gs://b/run/x.pt") == "gs://b/run"


def test_roundtrip(any_dir):
  path = fileio.join(any_dir, "sub", "a.txt")
  fileio.makedirs(fileio.dirname(path))
  fileio.atomic_write(path, "hello")
  assert fileio.exists(path)
  assert fileio.read_text(path) == "hello"
  assert fileio.read_bytes(path) == b"hello"
  assert fileio.getsize(path) == 5
  fileio.atomic_write(path, "rewritten")
  assert fileio.read_text(path) == "rewritten"
  fileio.atomic_write(fileio.join(any_dir, "sub", "0.txt"), b"zero")
  assert fileio.listdir(fileio.join(any_dir, "sub")) == ["0.txt", "a.txt"]
  assert fileio.isdir(fileio.join(any_dir, "sub"))
  assert not fileio.isdir(path)
  assert fileio.glob(fileio.join(any_dir, "sub", "a*.txt")) == [path]
  fileio.remove(path)
  assert not fileio.exists(path)
  with pytest.raises(FileNotFoundError):
    fileio.read_text(path)


def test_rename_and_rmtree(any_dir):
  src, dst = fileio.join(any_dir, "d", "src"), fileio.join(any_dir, "d", "dst")
  fileio.makedirs(fileio.join(any_dir, "d"))
  fileio.atomic_write(src, b"payload")
  fileio.atomic_write(dst, b"old")
  fileio.rename(src, dst)
  assert not fileio.exists(src) and fileio.read_bytes(dst) == b"payload"
  fileio.rmtree(fileio.join(any_dir, "d"))
  assert not fileio.exists(dst)


def test_append_text(any_dir):
  path = fileio.join(any_dir, "log.csv")
  fileio.append_text(path, "a,b\n")
  fileio.append_text(path, "1,2\n")
  assert fileio.read_text(path) == "a,b\n1,2\n"


def test_create_exclusive_first_writer_wins(any_dir):
  path = fileio.join(any_dir, "MARKER")
  assert fileio.create_exclusive(path, "first") is True
  assert fileio.create_exclusive(path, "second") is False
  assert fileio.read_text(path) == "first"
  fileio.remove(path)
  assert fileio.create_exclusive(path, "third") is True
  assert fileio.read_text(path) == "third"


def test_create_exclusive_concurrent(any_dir):
  """Eight racing writers: one wins, and the content is all of its."""
  path = fileio.join(any_dir, "RACE")
  wins = []

  def attempt(i):
    if fileio.create_exclusive(path, f"writer-{i}"):
      wins.append(i)

  threads = [threading.Thread(target=attempt, args=(i,)) for i in range(8)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=30)
  assert not any(t.is_alive() for t in threads)
  assert len(wins) == 1
  assert fileio.read_text(path) == f"writer-{wins[0]}"


def test_appendable_file(any_dir):
  path = fileio.join(any_dir, "metrics.jsonl")
  f = fileio.AppendableFile(path)
  f.write("l1\n")
  f.flush()
  assert fileio.read_text(path) == "l1\n"
  f.write("l2\n")
  f.close()
  f2 = fileio.AppendableFile(path)   # a restarted job keeps the lines
  f2.write("l3\n")
  f2.close()
  assert fileio.read_text(path) == "l1\nl2\nl3\n"


@pytest.mark.parametrize("mode", ["a", "x", "ab"])
def test_remote_append_and_exclusive_modes_rejected(mem_dir, mode):
  with pytest.raises(ValueError):
    fileio.open(fileio.join(mem_dir, "x"), mode)


def test_binary_open(any_dir):
  path = fileio.join(any_dir, "blob.bin")
  with fileio.open(path, "wb") as f:
    f.write(b"\x00\x01\x02")
  with fileio.open(path, "rb") as f:
    assert f.read() == b"\x00\x01\x02"


# ---------------------------------------------------------------------------
# The services on GCS: real gcsfs against the fake server.
# ---------------------------------------------------------------------------


class _ResumableHandler(fake_gcs._Handler):
  """The fake's handler with GCS's resumable uploads: a POST with
  ``uploadType=resumable`` opens a session at a ``Location``, each part
  comes as a POST there with a ``Content-Range``, answered 308 with the
  bytes held until the last, which stores the object (412 when
  ``ifGenerationMatch=0`` finds it)."""

  def do_POST(self):
    url = urllib.parse.urlparse(self.path)
    query = urllib.parse.parse_qs(url.query)
    parts = url.path.strip("/").split("/")
    length = int(self.headers.get("Content-Length") or 0)
    if query.get("uploadType") == ["resumable"]:
      meta = json.loads(self.rfile.read(length) or b"{}")
      sid = uuid.uuid4().hex
      self.server.sessions[sid] = dict(
          bucket=urllib.parse.unquote(parts[4]), key=meta["name"],
          data=bytearray(),
          match=query.get("ifGenerationMatch", [None])[0])
      host, port = self.server.server_address
      self.send_response(200)
      self.send_header("Location", f"http://{host}:{port}/resumable/{sid}")
      self.send_header("Content-Length", "0")
      self.end_headers()
      return None
    if parts[0] == "resumable":
      session = self.server.sessions[parts[1]]
      session["data"] += self.rfile.read(length)
      total = self.headers["Content-Range"].rsplit("/", 1)[1]
      if total == "*" or len(session["data"]) < int(total):
        self.send_response(308)
        self.send_header("Range", f"bytes=0-{len(session['data']) - 1}")
        self.send_header("Content-Length", "0")
        self.end_headers()
        return None
      del self.server.sessions[parts[1]]
      data = bytes(session["data"])
      gen = self.store.put(session["bucket"], session["key"], data,
                           session["match"])
      if gen is None:
        return self._error(412, "conditionNotMet: ifGenerationMatch=0")
      return self._reply(200, fake_gcs._resource(
          session["bucket"], session["key"], data, gen))
    return super().do_POST()

  def do_DELETE(self):
    """Cancelling a resumable session: GCS answers 499."""
    parts = urllib.parse.urlparse(self.path).path.strip("/").split("/")
    if parts[0] == "resumable":
      self.server.sessions.pop(parts[1], None)
      self.send_response(499)
      self.send_header("Content-Length", "0")
      self.end_headers()
      return None
    return super().do_DELETE()


@pytest.fixture(scope="module")
def gcs():
  """A live fake-GCS endpoint as the seam's ``gs`` filesystem."""
  server = fake_gcs.FakeGCSServer()
  server._httpd.RequestHandlerClass = _ResumableHandler
  server._httpd.sessions = {}
  with server:
    old = fileio._FS_CACHE.get("gs")
    fileio._FS_CACHE["gs"] = gcsfs.GCSFileSystem(
        token="anon", endpoint_url=server.endpoint,
        use_listings_cache=False, skip_instance_cache=True)
    try:
      yield server
    finally:
      if old is None:
        fileio._FS_CACHE.pop("gs", None)
      else:
        fileio._FS_CACHE["gs"] = old


def _gs(server, *parts):
  return "/".join([f"gs://{server.bucket}", *parts])


def test_gcs_preemption_first_writer_wins(gcs):
  workdir = _gs(gcs, "preempt")
  guards = [PreemptionGuard(workdir, initial_step=10, process_index=r)
            for r in range(2)]
  guards[1].request_stop()
  assert not guards[1].should_stop(12)       # its target: 14
  guards[0].request_stop()
  assert not guards[0].should_stop(13)       # loses: 15 never lands
  assert fileio.read_text(fileio.join(workdir, MARKER)) == "14"
  assert [g.should_stop(14) for g in guards] == [True, True]
  guards[0].cleanup()
  assert not fileio.exists(fileio.join(workdir, MARKER))


def test_gcs_poll_survives_listing_lag(gcs):
  ckpt_dir = _gs(gcs, "lag", "checkpoints")
  gcs.put_object("lag/checkpoints/checkpoint_1.pt", b"1")
  gcs.put_object("lag/checkpoints/checkpoint_2.pt", b"2")
  gcs.set_list_lag("lag/checkpoints/checkpoint_2.pt", 4)
  manager = TaskManager(ckpt_dir)
  got = []
  for step in manager.unevaluated_checkpoints(timeout=30,
                                              poll_interval=0.01):
    got.append(step)
    if step == 2:
      manager.mark_training_done()
  assert got == [1, 2]


def test_gcs_scores_and_train_done(gcs):
  ckpt_dir = _gs(gcs, "scores", "checkpoints")
  manager = TaskManagerWithCsvResults(ckpt_dir)
  assert not manager.is_training_done()
  manager.add_eval_result(1, {"eval/fid": 12.5})
  manager.add_eval_result(2, {"eval/fid": 11.0})
  manager.mark_training_done()
  again = TaskManagerWithCsvResults(ckpt_dir)
  assert again.is_training_done()
  assert again._evaluated_steps() == [1, 2]
  with fileio.open(fileio.join(ckpt_dir, "scores.csv")) as f:
    rows = list(csv.DictReader(f))
  assert [(r["step"], float(r["eval/fid"])) for r in rows] == [
      ("1", 12.5), ("2", 11.0)]


def _tensors(state):
  out = {f"g.{k}": v for k, v in state.generator.state_dict().items()}
  out.update({f"d.{k}": v
              for k, v in state.discriminator.state_dict().items()})
  out.update({f"ema.{k}": v for k, v in state.ema_params.items()})
  for net, opt in (("g", state.g_opt), ("d", state.d_opt)):
    for i, slots in opt.state_dict()["state"].items():
      out.update({f"{net}_opt.{i}.{k}": v for k, v in slots.items()})
  return out


def test_gcs_checkpoint_bit_for_bit(gcs, tmp_path):
  config = coco_xmc.get_test_config()
  run, _ = train_lib.setup(config, torch.device("cpu"))
  train_lib.timed_step(run, config, torch.device("cpu"))
  state, _, stream = run
  remote = checkpoint.CheckpointManager(_gs(gcs, "ckpt", "checkpoints"))
  local = checkpoint.CheckpointManager(str(tmp_path))
  try:
    _, size = remote.save(1, state, stream)
    _, local_size = local.save(1, state, stream)
  finally:
    stream.close()
  assert size > 5 * 2**20                     # a resumable upload
  assert size == fileio.getsize(remote.path(1))
  assert local_size == os.path.getsize(local.path(1))
  assert remote.all_steps() == [1]
  got, want = (create_train_state(config, "cpu", seed=config.seed + 7)
               for _ in range(2))
  remote.restore(1, got)
  local.restore(1, want)
  a, b = _tensors(got), _tensors(want)
  assert set(a) == set(b) and got.step == want.step == state.step
  for name in b:
    assert torch.equal(a[name], b[name]), name
  for name, value in _tensors(state).items():
    assert torch.equal(a[name], value), name


class _Unpicklable:
  def __reduce__(self):
    raise RuntimeError("interrupted while serializing")


def _fail_part(monkeypatch, last):
  """Makes gcsfs's second part upload, or its last (which finalizes the
  object), fail, as a dropped connection does."""
  calls = []
  upload = gcsfs.core.GCSFile._upload_chunk

  def flaky(self, final=False):
    calls.append(final)
    if (final if last else len(calls) == 2):
      raise OSError("part upload failed")
    return upload(self, final)

  monkeypatch.setattr(gcsfs.core.GCSFile, "_upload_chunk", flaky)
  return calls


@pytest.mark.parametrize("where,fault", [("gcs", "part"), ("gcs", "last"),
                                         ("gcs", "serialize"),
                                         ("memory", "serialize")])
def test_failed_save_publishes_no_checkpoint(gcs, monkeypatch, where, fault):
  """A save that fails partway leaves nothing that `list_steps` lists: the
  upload is cancelled and the file never closed (closing would publish
  what was written), and a later save of the step goes through."""
  name = f"failed-{where}-{fault}-{uuid.uuid4().hex[:8]}"
  directory = (_gs(gcs, name, "checkpoints") if where == "gcs"
               else f"memory://{name}/checkpoints")
  path = fileio.join(directory, "checkpoint_3.pt")
  fileio.makedirs(directory)
  big = torch.arange(3 * 2**20, dtype=torch.float32)   # 12 MiB a part
  payload = {"weights": big, "more": -big}
  calls = []
  if fault == "serialize":
    payload["last"] = _Unpicklable()
  else:
    calls = _fail_part(monkeypatch, last=fault == "last")
  with pytest.raises((OSError, RuntimeError)):
    checkpoint.write(payload, path)
  if fault != "serialize":
    assert calls == [False] * (len(calls) - 1) + [fault == "last"]
    assert len(calls) >= 2                    # a part was uploaded
    monkeypatch.undo()
  gc.collect()                                # no close at collection
  assert checkpoint.list_steps(directory) == []
  assert not fileio.exists(path)
  if where == "gcs":
    assert gcs._httpd.sessions == {}          # the session was cancelled
  checkpoint.write(payload := {"weights": big, "more": -big}, path)
  assert checkpoint.list_steps(directory) == [3]
  got = checkpoint.load(path)
  assert set(got) == set(payload)
  assert all(torch.equal(got[k], payload[k]) for k in payload)
  fileio.rmtree(fileio.dirname(directory))


# ---------------------------------------------------------------------------
# Every mode on one gs:// workdir, and two processes of one run.
# ---------------------------------------------------------------------------


def _env(server, rank=None, port=None):
  env = dict(os.environ)
  env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
  env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
             STORAGE_EMULATOR_HOST=server.endpoint, FSSPEC_GS_TOKEN="anon")
  for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
    env.pop(key, None)
  if rank is not None:
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
  return env


def _train_ranks(server, workdir, steps, cwd):
  """Both processes of a two-process ``--mode=train``, to the end."""
  port = td.free_port()
  procs = [subprocess.Popen(
      [sys.executable, "-m", "xmcgan_image_generation_tpu_torch.main",
       f"--workdir={workdir}", "--config=test", "--device=cpu",
       f"--num_train_steps={steps}", "--config.eval_every_steps=100000"],
      env=_env(server, rank, port), cwd=cwd, stdout=subprocess.PIPE,
      stderr=subprocess.STDOUT, text=True) for rank in range(2)]
  outs = []
  try:
    for proc in procs:
      outs.append(proc.communicate(timeout=300)[0])
  finally:
    for proc in procs:
      if proc.poll() is None:
        proc.kill()
        proc.communicate()
  codes = [p.returncode for p in procs]
  if codes != [0, 0]:
    raise RuntimeError(f"exit codes {codes}: {outs[0][-3000:]}")


class _TwoProcesses(threading.Thread):
  """A two-process run on ``gs://``: one step, then a resume to step 2;
  beside it the same two steps uninterrupted on a local workdir."""

  def __init__(self, server, root):
    super().__init__(daemon=True)
    self.server, self.root = server, root
    self.workdir = _gs(server, "ddp")
    self.local = os.path.join(root, "whole")
    self.cwd = os.path.join(root, "cwd")
    self.loaders_at_1, self.error = None, None

  def run(self):
    try:
      os.makedirs(self.cwd)
      whole = threading.Thread(target=_train_ranks, daemon=True, args=(
          self.server, self.local, 2, self.root))
      whole.start()
      _train_ranks(self.server, self.workdir, 1, self.cwd)
      ckpt_dir = checkpoint.checkpoints_dir(self.workdir)
      self.loaders_at_1 = {
          name: fileio.read_bytes(fileio.join(ckpt_dir, name))
          for name in fileio.listdir(ckpt_dir) if ".loader_" in name}
      _train_ranks(self.server, self.workdir, 2, self.cwd)
      whole.join(timeout=300)
    except BaseException as e:  # noqa: BLE001 - raised in the test
      self.error = e


@pytest.fixture(scope="module")
def two_processes(gcs, tmp_path_factory):
  runs = _TwoProcesses(gcs, str(tmp_path_factory.mktemp("ddp")))
  runs.start()
  return runs


@pytest.fixture(scope="module")
def two_processes_done(two_processes):
  two_processes.join(timeout=600)
  assert not two_processes.is_alive()
  if two_processes.error is not None:
    raise two_processes.error
  return two_processes


MODES = ("train", "test", "generate", "export")


@pytest.fixture(scope="module")
def chain(gcs, two_processes, tmp_path_factory):
  """``main`` in each mode on ``gs://bucket/chain`` (one step and its
  checkpoint, so that the evaluation scores one step), from an empty
  working directory; then a local export of the same checkpoint."""
  workdir = _gs(gcs, "chain")
  cwd = tmp_path_factory.mktemp("cwd")
  old = os.getcwd()
  os.chdir(cwd)
  try:
    for mode in MODES:
      main_lib.main(["--workdir", workdir, "--config=test", "--device=cpu",
                     f"--mode={mode}", "--num_train_steps=1"])
  finally:
    os.chdir(old)
  local = str(tmp_path_factory.mktemp("local_export"))
  (local_pt2,) = serving.export_from_workdir(
      coco_xmc.get_test_config(), workdir, device="cpu", out_dir=local)
  files = {key[len("chain/"):]: len(data)
           for key, (data, _) in gcs.objects().items()
           if key.startswith("chain/")}
  return dict(workdir=workdir, cwd=str(cwd), files=files,
              local_pt2=local_pt2)


def test_chain_leaves_nothing_on_local_disk(chain):
  assert os.listdir(chain["cwd"]) == []


@pytest.mark.parametrize("mode,expected", [
    ("train", ("checkpoints/checkpoint_1.pt", "checkpoints/TRAIN_DONE",
               "metrics.jsonl", "hparams.json", "checkpoints.jsonl",
               "images/ema_generated_image_00000001.png")),
    ("test", ("checkpoints/scores.csv",)),
    ("generate", ("samples/step00000001_batch0_ema_generated_image.png",)),
    ("export", ("serving/generator_ema_step00000001.pt2",
                "serving/generator_ema_step00000001.json")),
])
def test_chain_writes_each_mode_to_the_store(chain, mode, expected):
  assert set(expected) <= set(chain["files"]), sorted(chain["files"])
  assert all(chain["files"][name] > 0 for name in expected)
  if mode == "train":
    assert any(n.startswith("events.out.tfevents.") for n in chain["files"])
    lines = fileio.read_text(fileio.join(chain["workdir"],
                                         "metrics.jsonl")).splitlines()
    assert [json.loads(l)["step"] for l in lines if "d_loss" in l] == [1]
  if mode == "test":
    rows = list(csv.DictReader(io.StringIO(fileio.read_text(fileio.join(
        chain["workdir"], "checkpoints", "scores.csv")))))
    assert [r["step"] for r in rows] == ["1"]
    assert np.isfinite(float(rows[0]["eval/fid"]))


def test_chain_export_serves_as_local_export(chain):
  remote = serving.load_exported(fileio.join(
      chain["workdir"], "serving", "generator_ema_step00000001.pt2"))
  local = serving.load_exported(chain["local_pt2"])
  rng = np.random.default_rng(0)
  inputs = (torch.from_numpy(rng.standard_normal((3, 768), np.float32)),
            torch.from_numpy(rng.standard_normal((3, 17, 768), np.float32)),
            torch.tensor([[3.0], [17.0], [9.0]]),
            torch.from_numpy(rng.standard_normal((3, 8), np.float32)))
  got, want = remote.module()(*inputs), local.module()(*inputs)
  assert got.shape == (3, 32, 32, 3)
  assert torch.equal(got, want)


def _flat(tree, prefix=""):
  if isinstance(tree, dict):
    out = {}
    for k, v in tree.items():
      out.update(_flat(v, f"{prefix}{k}."))
    return out
  return {prefix: tree}


def test_two_processes_write_both_loader_states(two_processes_done):
  assert sorted(two_processes_done.loaders_at_1) == [
      "checkpoint_1.loader_0-of-2.pt", "checkpoint_1.loader_1-of-2.pt"]
  states = [torch.load(io.BytesIO(data), weights_only=True)
            for _, data in sorted(two_processes_done.loaders_at_1.items())]
  assert states[0]["position"] == states[1]["position"] > 0
  assert states[0]["loader"] != states[1]["loader"]   # each its own shard
  assert os.listdir(two_processes_done.cwd) == []


def test_two_processes_resume_bit_for_bit(two_processes_done):
  remote = checkpoint.checkpoints_dir(two_processes_done.workdir)
  local = checkpoint.checkpoints_dir(two_processes_done.local)
  assert checkpoint.list_steps(remote) == [1, 2]
  for name in ("checkpoint_2.pt", "checkpoint_2.loader_0-of-2.pt",
               "checkpoint_2.loader_1-of-2.pt"):
    got = _flat(checkpoint.load(fileio.join(remote, name)))
    want = _flat(checkpoint.load(os.path.join(local, name)))
    assert set(got) == set(want), name
    for key, value in want.items():
      if isinstance(value, torch.Tensor):
        assert torch.equal(got[key], value), (name, key)
      else:
        assert got[key] == value, (name, key)

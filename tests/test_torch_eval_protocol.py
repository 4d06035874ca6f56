"""The port's multi-process modes on the CPU (gloo): the statistics'
merge, the service's control plane, and generate and export under
``torchrun``'s environment.

* FID and IS statistics at world 2, each process streaming its rows of
  every global batch (the last one trimmed so that process 1 keeps no
  rows), against one process over the global batches and against the JAX
  package's ``utils/fid.py`` on them, ``num_splits`` 1 and 3: 1e-12
  relative on the statistics (with a floor of 1e-12 of the largest
  value: only the order of float64 sums differs), 1e-9 on FID and IS.
* `fid.local_rows` against JAX's ``_rows_from_shards`` on stand-in shards
  describing the same process's rows.
* One `EvalMetric` in each of two processes, each on its shard of the
  eval loader, scoring a CPU-trained test-config checkpoint (float32,
  ``eval_batch_size`` 4, ``eval_num`` 6): the merged real and generated
  statistics and IS against the JAX package's ``EvalMetric`` on the same
  global batches, with G's and its EMA's weights bridged from the
  checkpoint and the same InceptionV3 ``.npz``, its BatchNorm statistics
  fitted to its input (`_torch_dist.inception_npz`), so that the pool
  features spread over 5-20 % of their mean and IS is 1.9-2.3.  The
  features differ at float32 level (1e-4 of the largest value in
  ``test_torch_eval.py``), so the means are held at 1e-4 of the largest
  mean, a covariance at ``2e-4 * max|mu| * max std`` (what a feature
  error of 1e-4 of the largest feature moves it by; 4e-3 of the largest
  covariance for the real pool, 9e-4 for the generated ones, against
  gaps of 5e-6 and 1.3e-6), and IS - 1 at 1e-4 relative (gaps of 5e-6
  and 1.0e-5).  FID is a function of these
  statistics, the same in both packages (1e-9 apart in
  ``test_torch_eval.py``); ``test_torch_eval_parallel.py`` holds the
  service's FID against one process's.  The JAX side runs in its own
  interpreter without XLA's constant folding, which spends some 40 s
  folding InceptionV3's pooling counts on the CPU and changes no value.
* `evaluate._synchronized_steps` (the JAX package's
  ``tests/test_multihost.py`` cases, with a heartbeat of 0.2 s and a
  deadline of 3 s): a checkpoint that lands after the start reaches both
  processes, and no broadcast waits much longer than a heartbeat; a
  process 0 that dies, or that stalls past the deadline, makes the worker
  raise within 20 s.
* ``main.main`` at ``WORLD_SIZE=2`` in each of ``--mode=test``,
  ``generate`` and ``export`` runs (it raised before); generate's grids
  equal one process's on the same global batch within 1/255 a pixel,
  and the artifact serves what one process's export serves, bit for
  bit; process 1 writes no grid, artifact or score.
"""

import os
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest
import torch

import _torch_dist as td
from xmcgan_image_generation_tpu.utils import fid as j_fid
from xmcgan_image_generation_tpu_torch import generate as gen_lib
from xmcgan_image_generation_tpu_torch import train as train_lib
from xmcgan_image_generation_tpu_torch.data import png
from xmcgan_image_generation_tpu_torch.engine.sampling import generate_batch
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.utils import checkpoint
from xmcgan_image_generation_tpu_torch.utils import fid
from xmcgan_image_generation_tpu_torch.utils import image_utils
from xmcgan_image_generation_tpu_torch.utils import serving
from xmcgan_image_generation_tpu_torch.utils.task_manager import (
    TaskManagerWithCsvResults,
)

torch.set_num_threads(1)

INTERVAL, DEADLINE = 0.2, 3.0
WORKER_LIMIT = 20.0   # seconds within which a worker must fail


def _sigma_close(got, want):
  np.testing.assert_allclose(got, want, rtol=1e-12,
                             atol=1e-12 * np.abs(want).max())


# The JAX package's EvalMetric on the global batches of the port's
# checkpoint: argv workdir, Inception .npz, output .npz.
_JAX_SCRIPT = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import _torch_dist as td
    from xmcgan_image_generation_tpu.configs import coco_xmc
    from xmcgan_image_generation_tpu.engine.state import TrainState
    from xmcgan_image_generation_tpu.models import get_architecture
    from xmcgan_image_generation_tpu.utils import eval_metrics
    from xmcgan_image_generation_tpu.utils import inception_weights
    from xmcgan_image_generation_tpu_torch.engine.state import (
        create_train_state)
    from xmcgan_image_generation_tpu_torch.utils import bridge, checkpoint
    workdir, npz, out = sys.argv[1:]
    config = td.eval_config()
    j_config = coco_xmc.get_test_config()
    j_config.update(td.EVAL_OVERRIDES)
    j_config.inception_ckpt_path = npz
    manager = checkpoint.CheckpointManager(
        checkpoint.checkpoints_dir(workdir))
    state = manager.restore(manager.latest_step(), create_train_state(
        config, "cpu", seed=config.seed))
    g_vars = bridge.jax_from_state_dict(state.generator.state_dict())
    generator, _ = get_architecture(j_config, jax.numpy.float32)
    j_state = TrainState(
        step=0, g_params=g_vars["params"], d_params={}, g_opt_state=(),
        d_opt_state=(), generator_state={"batch_stats":
                                         g_vars["batch_stats"]},
        discriminator_state={},
        ema_params=bridge.tensors_to_jax(state.ema_params))
    # The template init of JAX's loader (a 299 px compile, only to check
    # names and shapes) is passed over: the .npz as it would return it.
    inception_weights.load_or_init = (
        lambda model, ckpt: inception_weights.unflatten_tree(
            dict(np.load(ckpt))))
    metric = eval_metrics.EvalMetric(
        iter(td.global_eval_batches(config, 4)), j_config)
    pools, scores = metric._generated_statistics(
        generator, j_state, jax.random.PRNGKey(0))
    result = {"real_mu": metric._real_mu, "real_sigma": metric._real_sigma}
    for key in ("normal", "ema"):
      result[key + "_mu"], result[key + "_sigma"] = pools[key].compute()
      result[key + "_is"] = scores[key].compute()[0]
    np.savez(out, **result)
""")

SYNC_MODES = ("protocol", "dead", "stalled")
FLAGS = [f"--config.{k}={v!r}" for k, v in td.EVAL_OVERRIDES.items()]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
  """Every multi-process run of the module, started at once: the three
  protocol cases (two ``python`` processes each), the statistics at world
  2, and ``main.main`` in each mode in two processes, on a CPU-trained
  test-config checkpoint whose step ``scores.csv`` already holds (so that
  ``--mode=test`` scores nothing)."""
  env = dict(os.environ)
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env["PYTHONPATH"] = os.pathsep.join([root, env.get("PYTHONPATH", "")])
  sync = {}
  for mode in SYNC_MODES:
    tmp = tmp_path_factory.mktemp(mode)
    ckpt_dir = str(tmp / "checkpoints")
    os.makedirs(ckpt_dir)
    port = td.free_port()
    procs = [subprocess.Popen(
        td.run(r, 2, port, str(tmp), "sync_case", ckpt_dir, mode, INTERVAL,
               DEADLINE), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env) for r in range(2)]
    sync[mode] = (procs, time.perf_counter(), tmp)
  fid_dir = str(tmp_path_factory.mktemp("fid"))
  fid_run = (td.start(2, "fid_case", fid_dir), 2, fid_dir)
  tmp = tmp_path_factory.mktemp("modes")
  config = td.eval_config(num_train_steps=1)
  workdir = str(tmp / "exp")
  train_lib.train(config, workdir, "cpu")
  TaskManagerWithCsvResults(checkpoint.checkpoints_dir(
      workdir)).add_eval_result(1, {"eval/fid": 0.0})
  modes_dir = str(tmp / "out")
  os.makedirs(modes_dir)
  ports = [td.free_port() for _ in td.MODES]
  modes_run = (td.start(2, "modes_case", modes_dir, workdir, ports, FLAGS,
                        torchrun=True), 2, modes_dir)
  npz = str(tmp / "inception.npz")
  td.inception_npz(npz)
  stats_dir = str(tmp / "statistics")
  os.makedirs(stats_dir)
  stats_run = (td.start(2, "eval_metric_case", stats_dir, workdir,
                        dict(inception_ckpt_path=npz)), 2, stats_dir)
  jax_env = dict(env, XLA_FLAGS="--xla_disable_hlo_passes=constant_folding",
                 PYTHONPATH=os.pathsep.join([os.path.join(root, "tests"),
                                             env["PYTHONPATH"]]))
  jax_out = str(tmp / "jax.npz")
  jax_log = open(tmp / "jax.log", "w")
  jax_proc = subprocess.Popen(
      [sys.executable, "-c", _JAX_SCRIPT, workdir, npz, jax_out],
      stdout=jax_log, stderr=subprocess.STDOUT, env=jax_env)
  return dict(sync=sync, fid=fid_run, modes=modes_run, workdir=workdir,
              config=config, tmp=tmp, statistics=stats_run,
              jax=(jax_proc, jax_out, tmp / "jax.log"))


@pytest.fixture(scope="module")
def sync_runs(launched):
  """``{mode: (return codes, outputs, each process's seconds to its
  end, results or None)}`` of the protocol cases."""
  runs = {}
  for mode, (procs, t0, tmp) in launched["sync"].items():
    ends = [None, None]
    while None in ends and time.perf_counter() - t0 < 60:
      for r, p in enumerate(procs):
        if ends[r] is None and p.poll() is not None:
          ends[r] = time.perf_counter() - t0
      time.sleep(0.05)
    outs = []
    for p in procs:
      if p.poll() is None:
        p.kill()
        outs.append("HUNG\n" + p.communicate()[0].decode())
      else:
        outs.append(p.communicate()[0].decode())
    results = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
               if os.path.exists(tmp / f"rank{r}.pt") else None
               for r in range(2)]
    runs[mode] = ([p.returncode for p in procs], outs, ends, results)
  return runs


def test_checkpoint_after_start_reaches_both(sync_runs):
  """Process 0 lists an empty directory, heartbeating, until a checkpoint
  lands ~2 s in: both processes get ``[5]``; process 0 sent heartbeats,
  and no broadcast waited as long as the deadline (heartbeats of 0.2 s;
  1 s allows for a loaded machine)."""
  codes, outs, _, results = sync_runs["protocol"]
  for r in range(2):
    assert codes[r] == 0, outs[r][-3000:]
    assert f"[rank {r}] steps=[5]" in outs[r]
    assert results[r]["steps"] == [5]
  heartbeats = results[0]["counts"]["broadcast/heartbeat"]["calls"]
  assert heartbeats >= 5, results[0]["counts"]
  # The worker received every heartbeat, the step and the end.
  assert results[1]["waits"] == heartbeats + 2
  assert results[1]["max_wait"] < 1.0, results[1]["max_wait"]


@pytest.mark.parametrize("mode", ["dead", "stalled"])
def test_worker_fails_without_coordinator(sync_runs, mode):
  """A dead process 0 (exit 17 ~1 s in) or one that stalls for three
  deadlines before it broadcasts: the worker raises, saying process 0 is
  gone, within 20 s, and does not hang."""
  codes, outs, ends, _ = sync_runs[mode]
  if mode == "dead":
    assert codes[0] == 17, outs[0][-3000:]
  assert codes[1] != 0, outs[1][-3000:]
  assert "HUNG" not in outs[1] and ends[1] is not None
  assert "process 0 is gone" in outs[1], outs[1][-3000:]
  assert "steps=" not in outs[1]
  assert ends[1] < WORKER_LIMIT, ends[1]


# ---------------------------------------------------------------------------
# Statistics over shards.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fid_world2(launched):
  return td.results(*launched["fid"])


def _jax_statistics():
  """JAX's streaming statistics over the global batches, trimmed alike."""
  inp = td.fid_inputs()
  out = {"pools": [], "scores": {}}
  for key in ("a", "b"):
    stats = j_fid.StreamingGaussianStats(td.FID_DIM)
    for i in range(td.FID_BATCHES):
      take = min(td.FID_ROWS, td.FID_TAKE - i * td.FID_ROWS)
      stats.update(inp[key][i * td.FID_ROWS:(i + 1) * td.FID_ROWS], take)
    out["pools"].append(stats.compute())
  for splits in (1, 3):
    score = j_fid.StreamingInceptionScore(td.FID_CLASSES, splits,
                                          td.FID_TAKE)
    for i in range(td.FID_BATCHES):
      take = min(td.FID_ROWS, td.FID_TAKE - i * td.FID_ROWS)
      score.update(inp["probs"][i * td.FID_ROWS:(i + 1) * td.FID_ROWS], take)
    out["scores"][splits] = score.compute()
  out["fid"] = j_fid.frechet_distance(*out["pools"][0], *out["pools"][1])
  return out


@pytest.mark.parametrize("reference", ["world1", "jax"])
def test_statistics_world2_match(fid_world2, reference):
  want = td.fid_case(None) if reference == "world1" else _jax_statistics()
  for res in fid_world2:
    for (mu, sigma), (w_mu, w_sigma) in zip(res["pools"], want["pools"]):
      _sigma_close(mu, w_mu)
      _sigma_close(sigma, w_sigma)
    np.testing.assert_allclose(res["fid"], want["fid"], rtol=1e-9)
    for splits in (1, 3):
      np.testing.assert_allclose(res["scores"][splits],
                                 want["scores"][splits], rtol=1e-9)
  # Every process holds the same bits.
  for a, b in zip(fid_world2[0]["pools"], fid_world2[1]["pools"]):
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_statistics_merge_once(fid_world2):
  """One merge a ``compute``: one gather of float64 and one of int64 for
  each of the two pools and the two scores; process 1, whose rows of the
  last batch are all cut away, joins them all."""
  dim, classes = td.FID_DIM, td.FID_CLASSES
  pool_bytes = 8 * (dim + dim * dim) + 8
  score_bytes = [8 * (s + s * classes) + 8 * s for s in (1, 3)]
  for res in fid_world2:
    assert res["counts"] == {"all_gather/host_sum": {
        "calls": 8, "bytes": 2 * pool_bytes + sum(score_bytes)}}


class _Mesh:

  def __init__(self, rank, world):
    self.rank, self.world = rank, world


@pytest.mark.parametrize("rank", [0, 1, 2])
@pytest.mark.parametrize("count", [None, 0, 2, 3, 5, 7, 9, 12])
def test_local_rows_match_jax_shards(rank, count):
  """Process ``rank`` of 3 holds rows ``[3 rank, 3 rank + 3)`` of a
  global batch of 9: the port's rows within the first ``count`` global
  rows equal JAX's walk of a shard with that index."""
  rows, dim = 3, 4
  data = np.random.default_rng(rank).standard_normal((rows, dim))
  shard = types.SimpleNamespace(
      index=(slice(rank * rows, (rank + 1) * rows), slice(None)), data=data)
  want = j_fid._rows_from_shards([shard], (dim,), count)
  got = fid.local_rows(torch.from_numpy(data), count, _Mesh(rank, 3))
  assert got.dtype == np.float64
  np.testing.assert_array_equal(got, want)
  if count is not None:
    assert fid.kept_rows(rows, count, _Mesh(rank, 3)) == want.shape[0]


# ---------------------------------------------------------------------------
# The modes under torchrun's environment.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def modes(launched):
  """The two processes' results of each mode, and one process's samples
  and artifact of the same checkpoint, made meanwhile: the samples of
  the same global batch (the second: the first is passed over) and an
  artifact written elsewhere."""
  config, workdir = launched["config"], launched["workdir"]
  state = checkpoint.CheckpointManager(checkpoint.checkpoints_dir(
      workdir)).restore(1, create_train_state(config, "cpu",
                                              seed=config.seed))
  batch = td.global_eval_batches(config, 2)[1]
  world1 = generate_batch(state, {k: torch.from_numpy(v) for k, v in
                                  batch.items()}, config)
  (artifact,) = serving.export_from_workdir(
      config, workdir, device="cpu", out_dir=str(launched["tmp"] / "world1"))
  return dict(workdir=workdir, results=td.results(*launched["modes"]),
              world1=world1, artifact=artifact, config=config)


@pytest.mark.parametrize("mode", td.MODES)
def test_main_runs_each_mode_at_world2(modes, mode):
  """``main.main`` under ``WORLD_SIZE=2`` runs each mode to its end on
  both processes (it raised ``NotImplementedError`` before)."""
  for rank, res in enumerate(modes["results"]):
    assert res[mode]["error"] is None, (rank, res[mode]["error"])


def test_only_process_0_writes(modes):
  """Process 0 wrote the three grids and the artifact once and appended
  no score (the checkpoint was scored); process 1 wrote nothing."""
  r0, r1 = (res["writes"] for res in modes["results"])
  assert r0 == {"grids": 3, "artifacts": 1, "scores": 0}
  assert r1 == {"grids": 0, "artifacts": 0, "scores": 0}
  samples = sorted(os.listdir(os.path.join(modes["workdir"], "samples")))
  assert samples == [f"step00000001_batch0_{n}.png" for n in sorted(
      gen_lib.GRIDS)]
  assert sorted(os.listdir(os.path.join(modes["workdir"], "serving"))) == [
      "generator_ema_step00000001.json", "generator_ema_step00000001.pt2"]


@pytest.mark.parametrize("name", gen_lib.GRIDS)
def test_generate_world2_matches_world1(modes, name):
  """Process 0's grid of the gathered global batch against one process's
  samples of the same global batch, saved alike: within 1/255 a
  pixel."""
  config = modes["config"]
  path = os.path.join(modes["workdir"], "samples",
                      f"step00000001_batch0_{name}.png")
  want_path = path + ".world1.png"
  image_utils.save_image(modes["world1"][name].numpy(), want_path,
                         config.show_num)
  got, want = (png.decode(open(p, "rb").read()).astype(np.int32)
               for p in (path, want_path))
  assert got.shape == want.shape
  assert np.abs(got - want).max() <= 1


def test_export_world2_matches_world1(modes):
  """The artifact written by process 0 of two serves what one process's
  export of the same checkpoint serves, bit for bit; process 1 waited
  for it at the control group's barrier."""
  config = modes["config"]
  path = os.path.join(modes["workdir"], "serving",
                      "generator_ema_step00000001.pt2")
  rng = torch.Generator().manual_seed(3)
  b = 3
  inputs = (torch.randn(b, serving.BERT_DIM, generator=rng),
            torch.randn(b, serving.COCO_MAX_TEXT_LENGTH, serving.BERT_DIM,
                        generator=rng),
            torch.randint(3, 18, (b, 1), generator=rng).float(),
            torch.randn(b, config.z_dim, generator=rng))
  got = serving.load_exported(path).module()(*inputs)
  want = serving.load_exported(modes["artifact"]).module()(*inputs)
  assert got.shape == (b, 32, 32, 3)
  torch.testing.assert_close(got, want, rtol=0, atol=0)
  for res in modes["results"]:
    assert res["export"]["counts"]["barrier/control"]["calls"] >= 1


# ---------------------------------------------------------------------------
# Two processes' statistics against the JAX package's EvalMetric.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def against_jax(launched):
  proc, out, log = launched["jax"]
  assert proc.wait(timeout=240) == 0, open(log).read()[-4000:]
  with np.load(out) as npz:
    jax_side = dict(npz)
  return td.results(*launched["statistics"]), jax_side


def _close_to_jax(mu, sigma, j_mu, j_sigma):
  """Statistics against JAX's (see the module's tolerances)."""
  scale = np.abs(j_mu).max()
  np.testing.assert_allclose(mu, j_mu, rtol=0, atol=1e-4 * scale)
  std = np.sqrt(np.abs(np.diagonal(j_sigma)).max())
  atol = 2e-4 * scale * std
  # The covariance tolerance means something only while the features
  # vary: it is 4e-3 of max |sigma| for the real pool, 9e-4 for the
  # generated ones.
  assert atol <= 1e-2 * np.abs(j_sigma).max(), atol / np.abs(j_sigma).max()
  np.testing.assert_allclose(sigma, j_sigma, rtol=0, atol=atol)


@pytest.mark.parametrize("what", ["real", "normal", "ema"])
def test_statistics_match_jax_eval_metric(against_jax, what):
  results, ref = against_jax
  for res in results:
    if what == "real":
      _close_to_jax(*res["real"], ref["real_mu"], ref["real_sigma"])
      continue
    mu, sigma, score = res["statistics"][what]
    _close_to_jax(mu, sigma, ref[f"{what}_mu"], ref[f"{what}_sigma"])
    np.testing.assert_allclose(score - 1, ref[f"{what}_is"] - 1, rtol=1e-4)
  # Both processes hold the same merged bits.
  a, b = (res["real"] if what == "real" else res["statistics"][what]
          for res in results)
  assert all(np.array_equal(x, y) for x, y in zip(a, b))

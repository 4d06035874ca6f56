"""Data-parallel training: the port's outer step over two processes (gloo,
on the CPU) against the jitted JAX ``train_step`` on a 2-device mesh and
against the port's one-process step, and a two-process ``main
--mode=train`` with a checkpoint, a resume and a SIGTERM to one process.

Both packages start from the JAX initialization (bridged into the port)
and take one outer step (one critic update, then one joint update) on
the same numpy-seeded super-batch ``z`` included, process-major: process
``r`` passes block ``r`` of it, as the JAX loop's processes do.  The JAX
step runs under ``MeshRules.create(2, devices=jax.devices()[:2])`` with
the state replicated and the batch sharded on ``data``; its heads are
the einsum form.  Cases of the port (test config, 32 px, width 16,
float32, the scale-fused dilated up-convs):

* ``einsum``, ``use_pallas`` (the sharded word-score dispatch and the
  fused NT-Xent, plain versions on the CPU) and ``remat`` (every block,
  policy ``full``): a 2 x 4 super-batch, against the same JAX step;
* ``accum``: ``grad_accum_steps=2`` on the 2 x 4 super-batch (one row of
  each microbatch a process), against JAX's accumulated step;
* ``grouped``: ``batch_norm_group_size=2`` and ``contrastive_group_size=2``
  on a 2 x 6 super-batch: 3 rows of each update a process, so that the
  middle group spans both; against JAX's grouped step (whose
  ``GroupedBatchNorm_0`` statistics are the initialization's
  ``BatchNorm_0`` ones, renamed).

Tolerances against JAX are ``test_torch_step.py``'s (losses and batch
statistics 1e-4 relative; gradients and Adam slots 1e-3 relative with
floors; parameters 2 lr an Adam step; ``u0`` 1e-3; the EMA a tenth of
G's).  On the 2 x 4 super-batch, after the critic update, G sits on a
ReLU kink: JAX's own G gradient moves by 4.8e-3 in ``Dense_1.bias`` when
``z`` is scaled by 1 + 1e-5 (by 1.8e-6 for 1 + 1e-6), the distance
between the two packages there.  For those three cases G's gradient and
slots are therefore held on the joint update alone, from the initial
state on the second sub-batch (as ``test_torch_accum.py`` holds each
update from the initial state); every other quantity on the outer step.  Against the port's one-process step on the same super-batch:
losses and the gradients of G (the joint update's) and of D (the critic
update's, from ``mu``) within 1e-5 relative, with an absolute floor of
1e-6 of the network's largest gradient for the entries that are float
noise (a conv bias before a BatchNorm).  The two processes' results are
bit for bit equal.

The world-2 processes and the world-1 process (`_torch_dist`, torch
only) run while the JAX steps compile, and the two-process training
runs, started first, run beside them.
"""

from concurrent import futures
import functools
import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import _torch_dist as td
from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.engine import create_train_state as j_state
from xmcgan_image_generation_tpu.engine import xmc_gan as j_xmc_gan
from xmcgan_image_generation_tpu.engine.step import split_batch as j_split
from xmcgan_image_generation_tpu.engine.step import train_step as j_step
from xmcgan_image_generation_tpu.models import get_architecture as j_arch
from xmcgan_image_generation_tpu.parallel import context as j_context
from xmcgan_image_generation_tpu.parallel.mesh import MeshRules
from xmcgan_image_generation_tpu_torch.data import synthetic
from xmcgan_image_generation_tpu_torch.utils import bridge
from xmcgan_image_generation_tpu_torch.utils import checkpoint
from xmcgan_image_generation_tpu_torch.utils.preemption import MARKER

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSSES = ("d_loss", "g_loss", "c_loss_d", "c_loss_g", "c_loss_g_pretrained")
GROUPED = dict(batch_norm_group_size=2, contrastive_group_size=2)
JAX_CASES = {"global": dict(batch_size=4),
             "accum": dict(batch_size=4, grad_accum_steps=2),
             "grouped": dict(batch_size=6, **GROUPED)}
PORT_CASES = {
    "einsum": ("global", dict(batch_size=4, use_pallas=False)),
    "use_pallas": ("global", dict(batch_size=4, use_pallas=True)),
    "remat": ("global", dict(batch_size=4, use_pallas=True, remat=True,
                             remat_min_resolution=0, remat_policy="full")),
    "accum": ("accum", dict(batch_size=4, use_pallas=True,
                            grad_accum_steps=2)),
    "grouped": ("grouped", dict(batch_size=6, use_pallas=True, **GROUPED)),
}


def _jax_config(case):
  config = j_coco_xmc.get_test_config()
  for k, v in {**td.STEP_OVERRIDES, **JAX_CASES[case]}.items():
    setattr(config, k, v)
  return config


def _super_batch(case):
  config = td.step_config(JAX_CASES[case])
  return synthetic.super_batch(config, np.random.default_rng(0))


def _flat(tree):
  return {k: np.asarray(v, np.float32)
          for k, v in bridge.flatten(jax.device_get(tree)).items()}


def _renamed(tree, old, new):
  if not isinstance(tree, dict):
    return tree
  return {new if k == old else k: _renamed(v, old, new)
          for k, v in tree.items()}


def _plain(tree):
  """A JAX tree as plain dicts of numpy arrays (picklable without flax)."""
  if hasattr(tree, "items"):
    return {k: _plain(v) for k, v in tree.items()}
  return np.asarray(tree)


def _pickled_state(s0, path, rename=None):
  """Writes what `_torch_dist.load_state` reads: the JAX state ``s0``,
  with G's ``BatchNorm_0`` scopes named ``rename`` if given."""
  generator_state = _plain(s0.generator_state)
  if rename:
    generator_state = _renamed(generator_state, "BatchNorm_0", rename)
  tree = dict(g_params=_plain(s0.g_params), generator_state=generator_state,
              d_params=_plain(s0.d_params),
              discriminator_state=_plain(s0.discriminator_state),
              ema_params=_plain(s0.ema_params))
  for net, opt_state in (("g", s0.g_opt_state), ("d", s0.d_opt_state)):
    adam = opt_state[0]
    tree.update({f"{net}_mu": _plain(adam.mu), f"{net}_nu": _plain(adam.nu),
                 f"{net}_count": int(adam.count)})
  with open(path, "wb") as f:
    pickle.dump(tree, f)
  return path


# ---------------------------------------------------------------------------
# Two-process training through ``main`` (started first, runs beside the
# step comparisons).
# ---------------------------------------------------------------------------


def _env(rank=None, port=None):
  env = dict(os.environ)
  env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
  env["OMP_NUM_THREADS"] = "1"
  env["CUDA_VISIBLE_DEVICES"] = ""
  for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
    env.pop(key, None)
  if rank is not None:
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
  return env


def _main_args(workdir, steps):
  return ["-m", "xmcgan_image_generation_tpu_torch.main",
          f"--workdir={workdir}", "--config=test", "--device=cpu",
          "--mode=train", f"--num_train_steps={steps}",
          "--config.use_pallas=True", "--config.log_loss_every_steps=1",
          # Cadences it never reaches: a checkpoint before the last step is
          # the preemption's.
          "--config.checkpoint_every_steps=100000",
          "--config.eval_every_steps=100000"]


def _start_ranks(workdir, steps):
  """Both processes of a run, as ``torchrun`` would set them up."""
  port = td.free_port()
  return [subprocess.Popen([sys.executable] + _main_args(workdir, steps),
                           env=_env(rank, port), cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True) for rank in range(2)]


def _finish(procs, timeout=300):
  outs = []
  try:
    for proc in procs:
      outs.append(proc.communicate(timeout=timeout)[0])
  finally:
    for proc in procs:
      if proc.poll() is None:
        proc.kill()
        proc.communicate()
  return [p.returncode for p in procs], outs


class _Training(threading.Thread):
  """A two-process run SIGTERMed in process 1 after the first step, its
  resume, and the same steps uninterrupted through ``torchrun``."""

  STEPS = 24

  def __init__(self, root):
    super().__init__(daemon=True)
    self.root = root
    self.result, self.error = {}, None

  def run(self):
    try:
      self._run()
    except BaseException as e:  # noqa: BLE001 - raised in the test
      self.error = e

  def _run(self):
    res = self.result
    preempted = os.path.join(self.root, "preempted")
    metrics = os.path.join(preempted, "metrics.jsonl")
    procs = _start_ranks(preempted, self.STEPS)
    deadline = time.time() + 300
    while not (os.path.exists(metrics) and open(metrics).read().strip()):
      if any(p.poll() is not None for p in procs) or time.time() > deadline:
        res["first"] = _finish(procs)
        raise RuntimeError(f"training ended or stalled before its first "
                           f"step: {res['first'][1][0][-3000:]}")
      time.sleep(0.02)
    procs[1].send_signal(signal.SIGTERM)
    res["first"] = _finish(procs)
    saved = checkpoint.list_steps(checkpoint.checkpoints_dir(preempted))
    res["saved"] = saved
    res["marker"] = open(os.path.join(preempted, MARKER)).read()
    res["losses_at_stop"] = _losses(preempted)
    res["loaders"] = {
        rank: torch.load(os.path.join(
            checkpoint.checkpoints_dir(preempted),
            f"checkpoint_{saved[-1]}.loader_{rank}-of-2.pt"),
            weights_only=True) for rank in range(2)}
    steps = saved[-1] + 2
    res["steps"] = steps
    resumed = _start_ranks(preempted, steps)
    whole = os.path.join(self.root, "whole")
    torchrun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2"] + _main_args(whole, steps),
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    res["resumed"] = _finish(resumed)
    res["whole"] = _finish([torchrun])
    res["dirs"] = (preempted, whole)


def _losses(workdir):
  with open(os.path.join(workdir, "metrics.jsonl")) as f:
    lines = [json.loads(line) for line in f]
  return [{k: v for k, v in line.items() if "seconds" not in k}
          for line in lines if "d_loss" in line]


@pytest.fixture(scope="module")
def training(tmp_path_factory):
  thread = _Training(str(tmp_path_factory.mktemp("ddp_train")))
  thread.start()
  return thread


# ---------------------------------------------------------------------------
# The step: JAX on a 2-device mesh, the port at world 2 and world 1.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def results(tmp_path_factory, training):
  tmp = tmp_path_factory.mktemp("ddp_step")
  batches = {case: _super_batch(case) for case in JAX_CASES}
  j_config = _jax_config("global")
  _, _, s0 = j_state(j_config, jax.random.PRNGKey(0),
                     j_split(batches["global"], 2)[0])
  s0 = jax.device_get(s0)
  grouped = s0.replace(generator_state=_renamed(
      _plain(s0.generator_state), "BatchNorm_0", "GroupedBatchNorm_0"))
  states = {"global": s0, "accum": s0, "grouped": grouped}
  paths = {"global": _pickled_state(s0, str(tmp / "global.pkl")),
           "grouped": _pickled_state(s0, str(tmp / "grouped.pkl"),
                                     rename="GroupedBatchNorm_0")}
  paths["accum"] = paths["global"]
  spawned = {}
  for world in (2, 1):
    # The joint update alone is held to JAX's at world 2 only.
    cases = [(label, overrides, paths[case], batches[case],
              world == 2 and case == "global")
             for label, (case, overrides) in PORT_CASES.items()]
    outdir = str(tmp_path_factory.mktemp(f"ddp_world{world}"))
    spawned[world] = (td.start(world, "step_cases", outdir, cases), world,
                      outdir)

  rules = MeshRules.create(2, devices=jax.devices()[:2])

  def outer_step(case):
    config = _jax_config(case)
    gen, disc = j_arch(config, jax.numpy.float32)
    step = jax.jit(functools.partial(
        j_step, generator=gen, discriminator=disc, config=config,
        additional_data={}))
    new, metrics = step(jax.random.PRNGKey(1),
                        jax.device_put(states[case], rules.replicated),
                        jax.device_put(batches[case], rules.batch))
    new = jax.device_get(new)
    return dict(
        losses={k: float(v) for k, v in metrics.items()},
        g_params=_flat(new.g_params), d_params=_flat(new.d_params),
        g_mu=_flat(new.g_opt_state[0].mu), g_nu=_flat(new.g_opt_state[0].nu),
        d_mu=_flat(new.d_opt_state[0].mu), d_nu=_flat(new.d_opt_state[0].nu),
        g_count=int(new.g_opt_state[0].count),
        d_count=int(new.d_opt_state[0].count),
        batch_stats=_flat(new.generator_state["batch_stats"]),
        u0=_flat(new.discriminator_state["spectral_norm_stats"]),
        ema=_flat(new.ema_params))

  def joint_alone():
    """G's slots after the joint update alone (see the module's
    docstring)."""
    config = _jax_config("global")
    gen, disc = j_arch(config, jax.numpy.float32)
    joint = jax.jit(functools.partial(
        j_xmc_gan.train_g_d, generator=gen, discriminator=disc,
        config=config, additional_data={}))
    new, _ = joint(jax.random.PRNGKey(2),
                   jax.device_put(s0, rules.replicated),
                   jax.device_put(j_split(batches["global"], 2)[1],
                                  rules.batch))
    new = jax.device_get(new)
    return dict(g_joint_mu=_flat(new.g_opt_state[0].mu),
                g_joint_nu=_flat(new.g_opt_state[0].nu))

  # The four programs compile at once (XLA compiles outside the GIL).
  try:
    with futures.ThreadPoolExecutor(4) as pool:
      steps = {case: pool.submit(outer_step, case) for case in states}
      joint = pool.submit(joint_alone)
      jax_out = {case: f.result() for case, f in steps.items()}
      jax_out["global"].update(joint.result())
  finally:
    j_context.set_ambient_mesh(None)
  world2, world1 = (td.results(*spawned[w]) for w in (2, 1))
  return dict(jax=jax_out, world1=world1[0], world2=world2)


def _close_trees(got, want, rtol, atol=0.0, scaled=0.0, floor=0.0):
  """``floor`` is a fraction of the largest magnitude in the whole tree."""
  assert set(got) == set(want)
  top = max(float(np.abs(v).max()) for v in want.values())
  for name in want:
    tol = max(atol + scaled * float(np.abs(want[name]).max()), floor * top)
    np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=tol,
                               err_msg=name)


def _gradients(res, slot):
  beta1 = td.step_config({}).beta1
  return {k: v / (1 - beta1) for k, v in res[slot].items()}


# What `test_torch_step.py` compares, with its tolerances.
_AGAINST_JAX = {
    "g_gradient": lambda got, want: _close_trees(
        _gradients(got, "g_mu"), _gradients(want, "g_mu"), rtol=1e-3,
        scaled=1e-3, floor=1e-5),
    "g_mu": lambda got, want: _close_trees(
        got["g_mu"], want["g_mu"], rtol=1e-3, scaled=1e-3, floor=1e-5),
    "g_nu": lambda got, want: _close_trees(
        got["g_nu"], want["g_nu"], rtol=1e-3, scaled=1e-3, floor=1e-10),
    "d_mu": lambda got, want: _close_trees(
        got["d_mu"], want["d_mu"], rtol=1e-3, scaled=1e-3, floor=1e-5),
    "d_nu": lambda got, want: _close_trees(
        got["d_nu"], want["d_nu"], rtol=1e-3, scaled=1e-3, floor=1e-10),
    "g_params": lambda got, want: _close_trees(
        got["g_params"], want["g_params"], rtol=0, atol=2 * 1e-4 * 1),
    "d_params": lambda got, want: _close_trees(
        got["d_params"], want["d_params"], rtol=0, atol=2 * 4e-4 * 2),
    "u0": lambda got, want: _close_trees(got["u0"], want["u0"], rtol=0,
                                         atol=1e-3),
    "batch_stats": lambda got, want: _close_trees(
        got["batch_stats"], want["batch_stats"], rtol=1e-4, atol=1e-5),
    "ema": lambda got, want: _close_trees(got["ema"], want["ema"], rtol=0,
                                          atol=2e-5),
}


@pytest.mark.parametrize("label", list(PORT_CASES))
def test_losses_match_jax(results, label):
  case = PORT_CASES[label][0]
  for res in results["world2"]:
    got = res[label]
    assert got["step"] == 1
    assert set(got["losses"]) == set(LOSSES)
    for k in LOSSES:
      np.testing.assert_allclose(got["losses"][k],
                                 results["jax"][case]["losses"][k],
                                 rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("quantity", list(_AGAINST_JAX))
@pytest.mark.parametrize("label", list(PORT_CASES))
def test_state_matches_jax(results, label, quantity):
  case = PORT_CASES[label][0]
  got, want = results["world2"][0][label], results["jax"][case]
  if case == "global" and quantity in ("g_gradient", "g_mu", "g_nu"):
    got = dict(got, g_mu=got["g_joint_mu"], g_nu=got["g_joint_nu"])
    want = dict(want, g_mu=want["g_joint_mu"], g_nu=want["g_joint_nu"])
  _AGAINST_JAX[quantity](got, want)


@pytest.mark.parametrize("label", list(PORT_CASES))
def test_adam_counts(results, label):
  got = results["world2"][0][label]
  assert got["g_count"] == results["jax"][PORT_CASES[label][0]]["g_count"]
  assert got["d_count"] == results["jax"][PORT_CASES[label][0]]["d_count"]
  assert (got["g_count"], got["d_count"]) == (1, 2)


@pytest.mark.parametrize("label", list(PORT_CASES))
def test_world2_matches_world1(results, label):
  got, want = results["world2"][0][label], results["world1"][label]
  for k in LOSSES:
    np.testing.assert_allclose(got["losses"][k], want["losses"][k],
                               rtol=1e-5, atol=1e-7, err_msg=k)
  for slot in ("g_mu", "d_mu"):
    _close_trees(_gradients(got, slot), _gradients(want, slot), rtol=1e-5,
                 floor=1e-6)


@pytest.mark.parametrize("label", list(PORT_CASES))
def test_replicas_bit_identical(results, label):
  first, second = (res[label] for res in results["world2"])
  assert first["losses"] == second["losses"]
  for key, value in first.items():
    if isinstance(value, dict) and key != "losses":
      assert set(value) == set(second[key])
      for name in value:
        np.testing.assert_array_equal(value[name], second[key][name],
                                      err_msg=f"{key}/{name}")


# ---------------------------------------------------------------------------
# ``main --mode=train`` over two processes.
# ---------------------------------------------------------------------------


def test_world2_main_preempts_checkpoints_and_resumes(training):
  """A SIGTERM to process 1 stops both at one agreed step, which process 0
  checkpoints (each process its own loader state beside it), without
  ``TRAIN_DONE``; the resumed run's losses equal an uninterrupted
  ``torchrun`` run's, and so do the final checkpoints, bit for bit."""
  training.join(600)
  assert not training.is_alive(), "the two-process runs did not end"
  if training.error is not None:
    raise training.error
  res = training.result
  rcs, outs = res["first"]
  assert rcs == [0, 0], outs[0][-3000:] + outs[1][-3000:]
  saved = res["saved"]
  assert len(saved) == 1 and saved[0] < _Training.STEPS, saved
  assert int(res["marker"]) == saved[0]
  assert [m["step"] for m in res["losses_at_stop"]] == list(
      range(1, saved[0] + 1))
  preempted, whole = res["dirs"]
  # Step k took each process's super-batch k: the next is saved + 1.
  for rank, state in res["loaders"].items():
    assert state["position"] == saved[0] + 1
    assert f"shard={rank}/2" in state["loader"]
  assert res["resumed"][0] == [0, 0], res["resumed"][1][0][-3000:]
  assert res["whole"][0] == [0], res["whole"][1][0][-3000:]
  for workdir in (preempted, whole):
    ckpt_dir = checkpoint.checkpoints_dir(workdir)
    assert os.path.exists(os.path.join(ckpt_dir, "TRAIN_DONE"))
    assert checkpoint.list_steps(ckpt_dir)[-1] == res["steps"]
  assert not os.path.exists(os.path.join(preempted, MARKER))
  assert _losses(preempted) == _losses(whole)
  payloads = [torch.load(checkpoint.CheckpointManager(
      checkpoint.checkpoints_dir(w)).path(res["steps"]), weights_only=True)
              for w in (preempted, whole)]
  for net in ("generator", "discriminator"):
    for name, value in payloads[1][net].items():
      assert torch.equal(payloads[0][net][name], value), f"{net}.{name}"

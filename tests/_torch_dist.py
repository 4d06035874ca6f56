"""Multi-process helpers of the port's data-parallel tests.

`start` spawns ``world`` processes that import torch, numpy and the port
and nothing of JAX, joins them in a gloo group on localhost (one process
runs without a group; or, as ``torchrun`` would, each gets the
environment and joins by itself), makes the group the ambient mesh
(`parallel.context`), runs one function of this module in each and saves
what it returns (``rank{r}.pt`` under the output directory), which
`results` reads back.  `run` starts one process of a group with a plain
``python`` command line, for the tests that watch a process die.  Every process builds its
inputs from the numpy seeds of the functions below, which the test
modules call too for the one-process and JAX sides.
"""

import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    return sock.getsockname()[1]


def _entry(rank, world, port, outdir, name, torchrun, args):
  torch.set_num_threads(1)
  from xmcgan_image_generation_tpu_torch.parallel import context
  from xmcgan_image_generation_tpu_torch.parallel.mesh import (
      init_process_group,
  )

  if world == 1 or torchrun:
    if torchrun:
      os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                        WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=str(port))
    out = globals()[name](None, *args)
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    return
  mesh = init_process_group("cpu", rank=rank, world_size=world,
                            init_method=f"tcp://127.0.0.1:{port}")
  try:
    with context.ambient_mesh(mesh):
      out = globals()[name](mesh, *args)
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
  finally:
    dist.destroy_process_group()


def start(world: int, name: str, outdir: str, *args, torchrun=False,
          blas_threads=None):
  """Spawns the processes running ``name(mesh, *args)``; returns their
  context (``join()`` until it returns True).  With ``torchrun`` no group
  is started: each process gets ``torchrun``'s environment (``RANK``,
  ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and
  ``mesh`` is None.  ``blas_threads`` caps numpy's BLAS threads in each
  (processes that each take ``sqrtm``s of 2048 x 2048 matrices would
  otherwise oversubscribe the cores)."""
  saved = dict(os.environ)
  if blas_threads:
    os.environ.update(OPENBLAS_NUM_THREADS=str(blas_threads),
                      OMP_NUM_THREADS=str(blas_threads))
  try:
    return mp.start_processes(_entry, args=(world, free_port(), outdir,
                                            name, torchrun, args),
                              nprocs=world, join=False,
                              start_method="spawn")
  finally:
    os.environ.clear()
    os.environ.update(saved)


def results(context, world: int, outdir: str):
  while not context.join():
    pass
  return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
          for r in range(world)]


def rows(x, mesh):
  """Process ``mesh.rank``'s contiguous rows of ``x`` (all of them
  without a mesh)."""
  if mesh is None:
    return x
  n = x.shape[0] // mesh.world
  return x[mesh.rank * n:(mesh.rank + 1) * n]


# ---------------------------------------------------------------------------
# Collectives.
# ---------------------------------------------------------------------------


def gather_weights(world: int) -> np.ndarray:
  return np.arange(world * 3 * 2, dtype=np.float32).reshape(world * 3, 2) + 1


def grad_shapes():
  return [(3,), (5, 7), (40, 2), (1,), (300,)]


def collectives_case(mesh):
  from xmcgan_image_generation_tpu_torch.parallel import collectives

  r, n = mesh.rank, mesh.world
  x = (torch.arange(6.0).reshape(3, 2) + 10 * r).requires_grad_()
  y = collectives.all_gather(x)
  (y * torch.from_numpy(gather_weights(n))).sum().backward()
  z = torch.full((4,), r + 1.0, requires_grad=True)
  summed = collectives.all_reduce_with_grad(z)
  (summed * (r + 1)).sum().backward()
  grads = [torch.full(s, float(r + 1)) + torch.arange(
      int(np.prod(s)), dtype=torch.float32).reshape(s) for s in grad_shapes()]
  # 64-byte buckets: several all_reduces, one tensor larger than a bucket.
  bucket_bytes, collectives.BUCKET_BYTES = collectives.BUCKET_BYTES, 64
  try:
    reduced = collectives.all_reduce_grads(grads)
  finally:
    collectives.BUCKET_BYTES = bucket_bytes
  state = [torch.full((3,), float(r)), torch.full((2, 2), r + 0.5),
           torch.full((2,), r, dtype=torch.int64)]
  collectives.broadcast_(state, src=0)
  batch = collectives.gather_batch({
      "image": torch.full((2, 3), r, dtype=torch.uint8),
      "z": torch.full((2, 1), r + 0.25)})
  return dict(
      gathered=y.detach().numpy(), x_grad=x.grad.numpy(),
      summed=summed.detach().numpy(), z_grad=z.grad.numpy(),
      sum=collectives.all_reduce(torch.tensor([r + 1.0, -r])).numpy(),
      max=collectives.all_reduce(torch.tensor([r + 1.0, -r]), "max").numpy(),
      reduced=[g.numpy() for g in reduced],
      state=[t.numpy() for t in state],
      batch={k: v.numpy() for k, v in batch.items()},
      counts=collectives.counts())


# ---------------------------------------------------------------------------
# BatchNorm and the contrastive heads.
# ---------------------------------------------------------------------------

OPS_BATCH, GROUP = 6, 2   # 3 rows a process at world 2: group 1 spans both
MODULATION_TERMS = ("gamma_local", "gamma_dense", "beta_local", "beta_dense")


def ops_inputs():
  rng = np.random.default_rng(11)
  b, c, hw, d, regions, words, dim = OPS_BATCH, 5, 3, 12, 9, 5, 16

  def normal(*shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)

  return dict(
      x=normal(b, c, hw, hw) + 0.5, ct=normal(b, c, hw, hw),
      scale=1 + normal(c, scale=0.1), bias=normal(c, scale=0.1),
      feat_a=normal(b, d), feat_b=normal(b, d),
      region=normal(b, regions, dim), word=normal(b, words, dim),
      max_len=rng.integers(2, words + 1, (b, 1)).astype(np.float32),
      g=normal(b, b),
      # The modulated norm's terms: local maps at factor 1, dense [b, c].
      gamma_local=normal(b, c, hw, hw, scale=0.5),
      gamma_dense=normal(b, c, scale=0.5),
      beta_local=normal(b, c, hw, hw, scale=0.5),
      beta_dense=normal(b, c, scale=0.5))


def batch_norm(x, ct, scale, bias, group_size=-1):
  """``(y, dx, dscale, dbias, running mean, running var)`` of a train-mode
  BatchNorm (with scale and bias) on ``x`` for the cotangent ``ct``."""
  from xmcgan_image_generation_tpu_torch.ops.normalization import (
      make_batch_norm,
  )

  bn = make_batch_norm(x.shape[1], group_size, use_scale=True,
                       use_bias=True)
  with torch.no_grad():
    bn.scale.copy_(torch.from_numpy(scale))
    bn.bias.copy_(torch.from_numpy(bias))
  xt = torch.from_numpy(np.ascontiguousarray(x)).requires_grad_()
  y = bn(xt)
  y.backward(torch.from_numpy(np.ascontiguousarray(ct)))
  return [t.detach().numpy().copy() for t in (
      y, xt.grad, bn.scale.grad, bn.bias.grad, bn.mean, bn.var)]


def modulated_norm(x, ct, *terms):
  """``(out, mean, var, dx, d gamma_local, d gamma_dense, d beta_local,
  d beta_dense)`` of ``modulated_batch_norm`` with a ReLU for the
  cotangent ``ct``."""
  from xmcgan_image_generation_tpu_torch.ops.cuda import modulated_norm as mn

  leaves = [torch.from_numpy(np.ascontiguousarray(t)).requires_grad_()
            for t in (x,) + terms]
  out, mean, var = mn.modulated_batch_norm(*leaves, relu=True)
  out.backward(torch.from_numpy(np.ascontiguousarray(ct)))
  return [t.detach().numpy().copy() for t in (out, mean, var)] + [
      t.grad.numpy() for t in leaves]


def nt_xent(feat_a, feat_b, **kw):
  """``(loss, acc, entropy, d_a, d_b)`` of the port's ``nt_xent``."""
  from xmcgan_image_generation_tpu_torch.ops import contrastive

  a = torch.from_numpy(np.ascontiguousarray(feat_a)).requires_grad_()
  b = torch.from_numpy(np.ascontiguousarray(feat_b)).requires_grad_()
  out = contrastive.nt_xent(a, b, **kw)
  out[0].backward()
  return [float(v.detach()) for v in out] + [a.grad.numpy(),
                                             b.grad.numpy()]


def word_loss(region, word, max_len, **kw):
  """``(loss, acc, entropy, d_region)`` of the port's ``word_loss``."""
  from xmcgan_image_generation_tpu_torch.ops import attention

  r = torch.from_numpy(np.ascontiguousarray(region)).requires_grad_()
  out = attention.word_loss(r, torch.from_numpy(np.ascontiguousarray(word)),
                            torch.from_numpy(np.ascontiguousarray(max_len)),
                            **kw)
  out[0].backward()
  return [float(v.detach()) for v in out] + [r.grad.numpy()]


def sharded_word_scores(mesh, region, word, max_len, g):
  """``(scores, d_region, d_word)`` of this process's rows through
  ``make_sharded_word_scores``, for the cotangent ``g`` of the whole
  ``[caption, image]`` matrix."""
  from xmcgan_image_generation_tpu_torch.ops.attention import padding_mask
  from xmcgan_image_generation_tpu_torch.ops.cuda import word_scores as ws

  r = torch.from_numpy(np.ascontiguousarray(region)).requires_grad_()
  w = torch.from_numpy(np.ascontiguousarray(word)).requires_grad_()
  mask = padding_mask(torch.from_numpy(max_len), word.shape[1])
  s = ws.make_sharded_word_scores(mesh)(r, w, mask)
  s.backward(torch.from_numpy(g))
  return [s.detach().numpy(), r.grad.numpy(), w.grad.numpy()]


def ops_case(mesh):
  inp = ops_inputs()
  local = {k: rows(v, mesh) for k, v in inp.items()
           if k not in ("scale", "bias", "g")}
  out = {}
  for name, group in (("bn", -1), ("grouped_bn", GROUP)):
    out[name] = batch_norm(local["x"], local["ct"], inp["scale"],
                           inp["bias"], group)
  for name, kw in (("ntxent", {}), ("ntxent_fused", dict(use_pallas=True)),
                   ("ntxent_group", dict(group_size=GROUP))):
    out[name] = nt_xent(local["feat_a"], local["feat_b"], **kw)
  for name, kw in (("word", {}), ("word_pallas", dict(use_pallas=True)),
                   ("word_group", dict(group_size=GROUP, use_pallas=True))):
    out[name] = word_loss(local["region"], local["word"], local["max_len"],
                          **kw)
  out["sharded"] = sharded_word_scores(mesh, local["region"], local["word"],
                                       local["max_len"], inp["g"])
  out["modulated_norm"] = modulated_norm(
      local["x"], local["ct"], *(local[k] for k in MODULATION_TERMS))
  return out


# ---------------------------------------------------------------------------
# The outer training step.
# ---------------------------------------------------------------------------

# The test config as ``test_torch_step.py`` runs it.
STEP_OVERRIDES = dict(dtype="float32", scale_fused_convs=True,
                      upconv_method="dilated")


def step_config(overrides):
  from xmcgan_image_generation_tpu_torch.configs import coco_xmc

  config = coco_xmc.get_test_config()
  config.update(**STEP_OVERRIDES)
  config.update(**overrides)
  return config


def load_state(config, path):
  """A port state of ``config`` holding the JAX state pickled at ``path``
  (plain dicts of numpy arrays: ``g_params``, ``generator_state``,
  ``d_params``, ``discriminator_state``, ``ema_params`` and each Adam's
  ``mu``, ``nu`` and ``count``)."""
  import pickle

  from xmcgan_image_generation_tpu_torch.engine.state import (
      create_train_state,
  )
  from xmcgan_image_generation_tpu_torch.utils import bridge

  with open(path, "rb") as f:
    s0 = pickle.load(f)
  state = create_train_state(config, "cpu", seed=0)
  bridge.load_jax_variables(state.generator, {"params": s0["g_params"],
                                              **s0["generator_state"]})
  bridge.load_jax_variables(state.discriminator, {
      "params": s0["d_params"], **s0["discriminator_state"]})
  for net, opt, module in (("g", state.g_opt, state.generator),
                           ("d", state.d_opt, state.discriminator)):
    bridge.load_adam_state(opt, module, s0[f"{net}_mu"], s0[f"{net}_nu"],
                           s0[f"{net}_count"])
  state.ema_params = bridge.tree_to_torch(s0["ema_params"])
  return state


def _flat(tree):
  from xmcgan_image_generation_tpu_torch.utils import bridge

  return {k: np.asarray(v, np.float32) for k, v in bridge.flatten(
      tree).items()}


def step_result(state, metrics):
  """What ``test_torch_step.py`` compares, as flat numpy trees."""
  from xmcgan_image_generation_tpu_torch.utils import bridge

  g_mu, g_nu, g_count = bridge.adam_state_to_jax(state.g_opt,
                                                 state.generator)
  d_mu, d_nu, d_count = bridge.adam_state_to_jax(state.d_opt,
                                                 state.discriminator)
  g_vars = bridge.jax_from_state_dict(state.generator.state_dict())
  d_vars = bridge.jax_from_state_dict(state.discriminator.state_dict())
  return dict(
      losses={k: float(v) for k, v in metrics.items()},
      g_params=_flat(g_vars["params"]), d_params=_flat(d_vars["params"]),
      g_mu=_flat(g_mu), g_nu=_flat(g_nu), d_mu=_flat(d_mu),
      d_nu=_flat(d_nu), g_count=g_count, d_count=d_count,
      batch_stats=_flat(g_vars["batch_stats"]),
      u0=_flat(d_vars["spectral_norm_stats"]),
      ema=_flat(bridge.tensors_to_jax(state.ema_params)), step=state.step)


def run_step(overrides, state_path, host_batch, joint_alone=False):
  """One outer step of the state pickled at ``state_path`` on this
  process's host rows (all of them without a process group); with
  ``joint_alone`` also G's Adam slots after the joint update alone from
  that state on its sub-batch (``g_joint_mu``, ``g_joint_nu``)."""
  from xmcgan_image_generation_tpu_torch.engine import xmc_gan
  from xmcgan_image_generation_tpu_torch.engine.step import (
      split_batch,
      train_step,
  )
  from xmcgan_image_generation_tpu_torch.parallel import collectives
  from xmcgan_image_generation_tpu_torch.utils import bridge

  config = step_config(overrides)
  batch = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in host_batch.items()}
  state, metrics = train_step(load_state(config, state_path), batch,
                              config, {})
  out = step_result(state, metrics)
  if joint_alone:
    sub = split_batch(collectives.gather_batch(batch),
                      config.d_step_per_g_step)[-1]
    joint = load_state(config, state_path)
    xmc_gan.train_g_d(joint, sub, config, {})
    mu, nu, _ = bridge.adam_state_to_jax(joint.g_opt, joint.generator)
    out["g_joint_mu"], out["g_joint_nu"] = _flat(mu), _flat(nu)
  return out


def step_cases(mesh, cases):
  """`run_step` of each ``(label, overrides, state_path, super_batch,
  joint_alone)`` on this process's rows of the super-batch
  (process-major)."""
  return {label: run_step(overrides, path,
                          {k: rows(v, mesh) for k, v in batch.items()},
                          joint_alone)
          for label, overrides, path, batch, joint_alone in cases}


# ---------------------------------------------------------------------------
# The evaluation service, generate and export.
# ---------------------------------------------------------------------------

EVAL_WORLD = 2
# The test config, in float32, with 2 rows a process of a global eval batch
# of 4; eval_num 6 trims the second batch of each pass to process 0's rows.
EVAL_OVERRIDES = dict(dtype="float32", eval_batch_size=4, eval_num=6)


def eval_config(**overrides):
  from xmcgan_image_generation_tpu_torch.configs import coco_xmc

  config = coco_xmc.get_test_config()
  config.update(**EVAL_OVERRIDES)
  config.update(**overrides)
  return config


def global_eval_batches(config, count: int, world: int = EVAL_WORLD):
  """The first ``count`` global eval batches of a run of ``world``
  processes: each process's batch ``k`` of ``create_datasets(...,
  process_index=r, process_count=world)``, concatenated process-major."""
  from xmcgan_image_generation_tpu_torch.data import pipeline

  streams = [iter(pipeline.create_datasets(
      config, seed=config.seed, process_index=r, process_count=world)[1])
      for r in range(world)]
  out = []
  for _ in range(count):
    parts = [next(it) for it in streams]
    out.append({k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
  return out


class _Calls:
  """Counts the calls of a function of a module or class in this
  process, still calling it."""

  def __init__(self, owner, name):
    self.count = 0
    original = getattr(owner, name)

    def counted(*args, **kw):
      self.count += 1
      return original(*args, **kw)

    setattr(owner, name, counted)


def inception_npz(path):
  """Writes the port's seeded InceptionV3 in the JAX ``.npz`` layout, each
  BatchNorm's statistics set to those of its input over a seeded batch of
  noise images, as a trained tower's fit its data, and the biases moved
  off zero.  With the init statistics the random tower maps every image
  to nearly the same pool features (their spread ~5e-6 of their mean),
  so near the float32 noise between the two packages that their
  covariances differ by 2 % of the largest, and IS is 1 + 3e-12."""
  from xmcgan_image_generation_tpu_torch.models.inception_v3 import (
      InceptionV3,
  )
  from xmcgan_image_generation_tpu_torch.ops.normalization import BatchNorm
  from xmcgan_image_generation_tpu_torch.utils import bridge

  model = InceptionV3().eval()
  rng = np.random.default_rng(1)
  for name, param in model.named_parameters():
    if name.endswith("bias"):
      with torch.no_grad():
        param.copy_(torch.from_numpy(
            0.1 * rng.standard_normal(param.shape)).float())

  def fit(module, args):
    x = args[0].float()
    module.mean.copy_(x.mean(dim=(0, 2, 3)))
    module.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

  hooks = [m.register_forward_pre_hook(fit) for m in model.modules()
           if isinstance(m, BatchNorm)]
  images = rng.uniform(-1.0, 1.0, (4, 299, 299, 3)).astype(np.float32)
  with torch.no_grad():
    model(torch.from_numpy(images))
  for hook in hooks:
    hook.remove()
  np.savez(path, **bridge.flat_from_state_dict(model.state_dict()))


# FID and IS statistics over shards: 5 global batches of 4 rows; 18 rows
# taken, so the last batch keeps process 0's 2 rows and none of process 1.
FID_BATCHES, FID_ROWS, FID_TAKE, FID_DIM, FID_CLASSES = 5, 4, 18, 16, 10


def fid_inputs():
  rng = np.random.default_rng(12)
  n = FID_BATCHES * FID_ROWS
  logits = rng.standard_normal((n, FID_CLASSES))
  return dict(
      a=rng.standard_normal((n, FID_DIM)).astype(np.float32),
      b=(1.5 * rng.standard_normal((n, FID_DIM)) + 0.3).astype(np.float32),
      probs=(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
             ).astype(np.float32))


def fid_case(mesh, num_splits_list=(1, 3)):
  """This process's rows of every global batch through the port's
  streaming statistics: ``{"pools": [(mu, sigma)] of a and b, "fid",
  "scores": {num_splits: (mean, std)}, "counts"}``."""
  from xmcgan_image_generation_tpu_torch.parallel import collectives
  from xmcgan_image_generation_tpu_torch.utils import fid

  collectives.reset_counts()
  inp = fid_inputs()
  batches = [{k: rows(v[i * FID_ROWS:(i + 1) * FID_ROWS], mesh)
              for k, v in inp.items()} for i in range(FID_BATCHES)]
  takes = [min(FID_ROWS, FID_TAKE - i * FID_ROWS) for i in range(
      FID_BATCHES)]
  pools = []
  for key in ("a", "b"):
    stats = fid.StreamingGaussianStats(FID_DIM)
    for batch, take in zip(batches, takes):
      stats.update(torch.from_numpy(batch[key]), take)
    pools.append(stats.compute())
  scores = {}
  for splits in num_splits_list:
    score = fid.StreamingInceptionScore(FID_CLASSES, splits, FID_TAKE)
    for batch, take in zip(batches, takes):
      score.update(torch.from_numpy(batch["probs"]), take)
    scores[splits] = score.compute()
  return dict(pools=pools, fid=fid.frechet_distance(*pools[0], *pools[1]),
              scores=scores, counts=collectives.counts())


def service_case(mesh, workdir, overrides):
  """`evaluate.evaluate_continuously` on ``workdir`` in this process of
  the group: its merged statistics, the rows it appended to
  ``scores.csv``, the collectives' counts and its timings."""
  from xmcgan_image_generation_tpu_torch import evaluate
  from xmcgan_image_generation_tpu_torch.parallel import collectives
  from xmcgan_image_generation_tpu_torch.utils import task_manager

  appended = _Calls(task_manager.TaskManagerWithCsvResults,
                    "add_eval_result")
  collectives.reset_counts()
  metric = evaluate.evaluate_continuously(eval_config(**overrides), workdir,
                                          "cpu", timeout=60)
  return dict(statistics=metric.last_statistics,
              real=(metric._real_mu, metric._real_sigma),
              appended=appended.count, counts=collectives.counts(),
              images=metric.last_images,
              host_batches=metric.last_host_batches,
              seconds=dict(real=metric.real_seconds,
                           generate=metric.last_generate_seconds,
                           score=metric.last_seconds))


def eval_metric_case(mesh, workdir, overrides, batches=None):
  """One `EvalMetric` scoring the workdir's latest checkpoint, over the
  global ``batches`` (numpy) or, without them, this process's eval
  stream: with ``batches`` ``{"row": the 8 values, "statistics", "real"}``;
  without, one generated pass's merged statistics and no FID
  (``{"statistics", "real"}``)."""
  from xmcgan_image_generation_tpu_torch.engine.state import (
      create_train_state,
  )
  from xmcgan_image_generation_tpu_torch.evaluate import eval_stream
  from xmcgan_image_generation_tpu_torch.utils import checkpoint
  from xmcgan_image_generation_tpu_torch.utils.eval_metrics import EvalMetric

  config = eval_config(**overrides)
  manager = checkpoint.CheckpointManager(checkpoint.checkpoints_dir(workdir))
  state = manager.restore(manager.latest_step(),
                          create_train_state(config, "cpu", seed=config.seed))
  stream = iter(batches) if batches is not None else eval_stream(config,
                                                                 "cpu")
  metric = EvalMetric(stream, config, "cpu")
  out = dict(real=(metric._real_mu, metric._real_sigma))
  if batches is not None:
    out["row"] = metric.calculate_inception_fid(state)
    out["statistics"] = metric.last_statistics
    return out
  pools, scores = metric._generated_statistics(state, None)
  stream.close()
  out["statistics"] = {key: pools[key].compute() + (scores[key].compute()[0],)
                       for key in pools}
  return out


MODES = ("test", "generate", "export")


def modes_case(mesh, workdir, ports, flags):
  """``main.main`` in each of `MODES` under ``torchrun``'s environment
  (``MASTER_PORT`` from ``ports``, one group a mode): what each returned
  on this process and what this process wrote."""
  from xmcgan_image_generation_tpu_torch import main
  from xmcgan_image_generation_tpu_torch.parallel import collectives
  from xmcgan_image_generation_tpu_torch.utils import image_utils
  from xmcgan_image_generation_tpu_torch.utils import serving
  from xmcgan_image_generation_tpu_torch.utils import task_manager

  writes = {"grids": _Calls(image_utils, "save_image"),
            "artifacts": _Calls(serving, "_write_artifacts"),
            "scores": _Calls(task_manager.TaskManagerWithCsvResults,
                             "add_eval_result")}
  out = {}
  for mode, port in zip(MODES, ports):
    os.environ["MASTER_PORT"] = str(port)
    collectives.reset_counts()
    try:
      main.main(["--workdir", workdir, "--config=test", "--device=cpu",
                 f"--mode={mode}", *flags])
      out[mode] = dict(error=None, counts=collectives.counts())
    except Exception as e:  # noqa: BLE001 - reported to the test
      out[mode] = dict(error=repr(e))
  out["writes"] = {k: v.count for k, v in writes.items()}
  return out


def sync_case(mesh, ckpt_dir, mode, interval, deadline):
  """`evaluate._synchronized_steps` over a checkpoint directory that is
  empty at the start (the JAX package's ``tests/test_multihost.py``):
  ``protocol``: process 0 writes a checkpoint ~2 s in, then
  ``TRAIN_DONE``; ``dead``: process 0 exits with code 17 ~1 s in;
  ``stalled``: process 0 sleeps past the workers' deadline before it
  joins.  Returns the steps and the longest wait of a broadcast on this
  process; prints ``steps=[...]`` (the processes of `run` print)."""
  import threading
  import time

  from xmcgan_image_generation_tpu_torch import evaluate
  from xmcgan_image_generation_tpu_torch.parallel import collectives
  from xmcgan_image_generation_tpu_torch.utils.task_manager import (
      TaskManager,
  )

  manager = TaskManager(ckpt_dir)
  rank = mesh.rank
  waits = []
  broadcast = collectives.broadcast_int

  def timed(*args, **kw):
    t0 = time.perf_counter()
    try:
      return broadcast(*args, **kw)
    finally:
      waits.append(time.perf_counter() - t0)

  collectives.broadcast_int = timed
  if rank == 0 and mode == "protocol":
    def land():
      time.sleep(2.0)
      open(os.path.join(ckpt_dir, "checkpoint_5.pt"), "w").close()
      manager.mark_training_done()
    threading.Thread(target=land, daemon=True).start()
  if rank == 0 and mode == "dead":
    def die():
      time.sleep(1.0)
      os._exit(17)
    threading.Thread(target=die, daemon=True).start()
  if rank == 0 and mode == "stalled":
    time.sleep(3 * deadline)
  collectives.reset_counts()
  steps = list(evaluate._synchronized_steps(
      manager, timeout=60, heartbeat_interval=interval,
      worker_deadline=deadline))
  print(f"[rank {rank}] steps={steps}", flush=True)
  return dict(steps=steps, max_wait=max(waits), waits=len(waits),
              counts=collectives.counts())


def run(rank: int, world: int, port: int, outdir: str, name: str, *args):
  """The command line of one process of a group, for `subprocess`:
  ``python _torch_dist.py RANK WORLD PORT OUTDIR NAME ARG...``; the
  arguments are read as Python literals."""
  import sys

  return [sys.executable, os.path.abspath(__file__), str(rank), str(world),
          str(port), outdir, name, *map(repr, args)]


if __name__ == "__main__":
  import ast
  import sys

  rank_, world_, port_, outdir_, name_ = sys.argv[1:6]
  _entry(int(rank_), int(world_), int(port_), outdir_, name_, False,
         tuple(ast.literal_eval(a) for a in sys.argv[6:]))

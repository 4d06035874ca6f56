"""Multi-process helpers of the port's data-parallel tests.

`start` spawns ``world`` processes that import torch, numpy and the port
and nothing of JAX, joins them in a gloo group on localhost (one process
runs without a group), makes the group the ambient mesh
(`parallel.context`), runs one function of this module in each and saves
what it returns (``rank{r}.pt`` under the output directory), which
`results` reads back.  Every process builds its
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


def _entry(rank, world, port, outdir, name, args):
  torch.set_num_threads(1)
  from xmcgan_image_generation_tpu_torch.parallel import context
  from xmcgan_image_generation_tpu_torch.parallel.mesh import (
      init_process_group,
  )

  if world == 1:
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


def start(world: int, name: str, outdir: str, *args):
  """Spawns the processes running ``name(mesh, *args)``; returns their
  context (``join()`` until it returns True)."""
  return mp.start_processes(_entry, args=(world, free_port(), outdir, name,
                                          args),
                            nprocs=world, join=False, start_method="spawn")


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
      g=normal(b, b))


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

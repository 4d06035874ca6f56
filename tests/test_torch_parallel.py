"""The port's data-parallel pieces across processes, on the CPU (gloo).

Spawned processes (`_torch_dist`, which imports torch and the port only)
take their rows of numpy-seeded inputs; what they compute is held to the
port in one process on all the rows and to the JAX package:

* the collectives at world 2 and 4: ``all_gather`` forward and backward
  (this process's rows of the cotangent), ``all_reduce`` (sum, max, and
  the differentiable sum), the flat-bucket gradient sum over several
  buckets, ``broadcast`` and the batch gather;
* at world 2, on a batch of 6 (3 rows a process, so that the second of
  the groups of 2 spans both processes): the global and the grouped
  BatchNorm (outputs, gradients, running averages), ``nt_xent`` (einsum
  and fused, and with ``group_size``), ``word_loss`` (einsum, the sharded
  dispatch, and with ``group_size``) and ``make_sharded_word_scores``'s
  scores, ``d_region`` and ``d_word``;
* JAX's ``GroupedBatchNorm``, ``nt_xent`` and ``word_loss`` with groups,
  and JAX's ``make_sharded_word_scores`` on a 2-device CPU mesh in
  interpret mode;
* the loader's shards against grain's ``ShardOptions(r, 2,
  drop_remainder=True)``, with 0 and 2 workers.

The processes are spawned once for the module (worlds of two, two and
four at once).  Tolerances: world 2 against world 1,
float32, other summation orders: 1e-5 relative (with an absolute floor
of 1e-5 of the largest value for gradients, which sum partial gradients
over processes).  Against JAX: the forward 1e-5 relative and 1e-6
absolute, gradients 1e-4 of their largest value, as in
``test_torch_kernels.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.data import pipeline as j_pipeline
from xmcgan_image_generation_tpu.ops import attention as j_attention
from xmcgan_image_generation_tpu.ops import contrastive as j_contrastive
from xmcgan_image_generation_tpu.ops import normalization as j_norm
from xmcgan_image_generation_tpu.ops.pallas import word_scores as j_ws
from xmcgan_image_generation_tpu.parallel.mesh import create_mesh
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.data import pipeline
from xmcgan_image_generation_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(1)

GAMMA = 5.0


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
  """Every process's results: ``{"ops": [ops at world 2], "coll": {2:
  [...], 4: [...]}}``; the three worlds run at once."""
  runs = {"ops": (2, "ops_case"), 2: (2, "collectives_case"),
          4: (4, "collectives_case")}
  started = {}
  for key, (world, name) in runs.items():
    outdir = str(tmp_path_factory.mktemp(f"{name}{world}"))
    started[key] = (td.start(world, name, outdir), world, outdir)
  res = {key: td.results(*value) for key, value in started.items()}
  return {"ops": res["ops"], "coll": {2: res[2], 4: res[4]}}


# ---------------------------------------------------------------------------
# Collectives.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_collectives(spawned, world):
  res = spawned["coll"][world]
  whole = np.concatenate([np.arange(6.0).reshape(3, 2) + 10 * r
                          for r in range(world)])
  weights = td.gather_weights(world)
  total = sum(r + 1 for r in range(world))
  for r, out in enumerate(res):
    np.testing.assert_array_equal(out["gathered"], whole)
    # The backward takes this process's rows of the (global) cotangent.
    np.testing.assert_array_equal(out["x_grad"], weights[3 * r:3 * r + 3])
    np.testing.assert_array_equal(out["summed"], np.full(4, total))
    # The differentiable sum's backward sums the cotangents (r + 1).
    np.testing.assert_array_equal(out["z_grad"], np.full(4, total))
    np.testing.assert_array_equal(out["sum"], [total, -sum(range(world))])
    np.testing.assert_array_equal(out["max"], [world, 0])
    for shape, got in zip(td.grad_shapes(), out["reduced"]):
      n = int(np.prod(shape))
      want = (world * np.arange(n, dtype=np.float32).reshape(shape)
              + total)
      np.testing.assert_array_equal(got, want)
    for got, fill in zip(out["state"], (0.0, 0.5, 0)):
      np.testing.assert_array_equal(got, np.full(got.shape, fill))
    np.testing.assert_array_equal(
        out["batch"]["image"], np.repeat(np.arange(world), 2)[:, None]
        * np.ones((1, 3), np.uint8))
    np.testing.assert_array_equal(out["batch"]["z"][:, 0],
                                  np.repeat(np.arange(world), 2) + 0.25)
    counts = out["counts"]
    # 2 + 1 + 4 + 3 (5 gradients in 64-byte buckets: 12, 140, 320, 4 and
    # 1200 bytes -> [12], [140], [320], [4], [1200]) + 1 + 2 + 1 + 1.
    assert counts["all_reduce/grads"]["calls"] == 5
    assert counts["all_reduce/grads"]["bytes"] == 4 * (3 + 35 + 80 + 1
                                                       + 300)
    assert counts["all_gather/batch"]["calls"] == 2
    assert counts["broadcast/state"]["calls"] == 2   # float32, int64


def test_mesh_keys():
  assert mesh_lib.data_axis_size(-1, 1, 4) == 4
  assert mesh_lib.data_axis_size(2, 1, 2) == 2
  with pytest.raises(ValueError, match="mesh_data=2"):
    mesh_lib.data_axis_size(2, 1, 4)
  with pytest.raises(ValueError, match="mesh_model=2"):
    mesh_lib.data_axis_size(-1, 2, 4)


def test_single_process_mesh(monkeypatch):
  """Without ``WORLD_SIZE`` the run is one process with no group, and
  ``to_host`` is the identity."""
  monkeypatch.delenv("WORLD_SIZE", raising=False)
  mesh = mesh_lib.init_process_group("cpu")
  assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
  x = np.arange(6).reshape(3, 2)
  np.testing.assert_array_equal(mesh_lib.to_host({"x": x})["x"], x)


# ---------------------------------------------------------------------------
# The ops at world 2 against world 1.
# ---------------------------------------------------------------------------


def _one_process():
  """The same functions on all the rows, without a process group."""
  inp = td.ops_inputs()
  out = {}
  for name, group in (("bn", -1), ("grouped_bn", td.GROUP)):
    out[name] = td.batch_norm(inp["x"], inp["ct"], inp["scale"], inp["bias"],
                              group)
  for name, kw in (("ntxent", {}), ("ntxent_fused", dict(use_pallas=True)),
                   ("ntxent_group", dict(group_size=td.GROUP))):
    out[name] = td.nt_xent(inp["feat_a"], inp["feat_b"], **kw)
  for name, kw in (("word", {}), ("word_pallas", dict(use_pallas=True)),
                   ("word_group", dict(group_size=td.GROUP,
                                       use_pallas=True))):
    out[name] = td.word_loss(inp["region"], inp["word"], inp["max_len"],
                             **kw)
  return out


@pytest.fixture(scope="module")
def one_process():
  return _one_process()


def _close(got, want, scale_floor=0.0):
  atol = scale_floor * float(np.abs(want).max()) if np.size(want) else 0.0
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=max(atol, 1e-7))


def _concat_rows(results, key, index):
  return np.concatenate([r[key][index] for r in results])


@pytest.mark.parametrize("name", ["bn", "grouped_bn"])
def test_batch_norm_world2_matches_world1(spawned, one_process, name):
  """y and dx by rows, d_scale and d_bias summed over processes, the same
  running averages on both."""
  res, want = spawned["ops"], one_process[name]
  _close(_concat_rows(res, name, 0), want[0])
  _close(_concat_rows(res, name, 1), want[1], 1e-5)
  for i in (2, 3):
    _close(sum(r[name][i] for r in res), want[i], 1e-5)
  for r in res:
    for i in (4, 5):
      _close(r[name][i], want[i])


@pytest.mark.parametrize("name", ["ntxent", "ntxent_fused", "ntxent_group",
                                  "word", "word_pallas", "word_group"])
def test_contrastive_heads_world2_match_world1(spawned, one_process, name):
  """The same global loss, accuracy and entropy on each process; each
  process's rows of the gradient."""
  res, want = spawned["ops"], one_process[name]
  for r in res:
    _close(np.array(r[name][:3]), np.array(want[:3]))
  for i in range(3, len(want)):
    _close(_concat_rows(res, name, i), want[i], 1e-5)


# ---------------------------------------------------------------------------
# Against the JAX package.
# ---------------------------------------------------------------------------


def _jax_grouped_bn(x_nchw, ct_nchw, scale, bias):
  module = j_norm.GroupedBatchNorm(group_size=td.GROUP)
  x = jnp.asarray(x_nchw.transpose(0, 2, 3, 1))
  ct = jnp.asarray(ct_nchw.transpose(0, 2, 3, 1))
  variables = module.init(jax.random.PRNGKey(0), x)
  params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

  def f(x, params):
    return module.apply({"params": params,
                         "batch_stats": variables["batch_stats"]}, x,
                        mutable=["batch_stats"])

  y, state = f(x, params)
  _, pullback = jax.vjp(lambda x, p: f(x, p)[0], x, params)
  dx, dparams = pullback(ct)
  to_nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
  stats = state["batch_stats"]
  return [to_nchw(y), to_nchw(dx), np.asarray(dparams["scale"]),
          np.asarray(dparams["bias"]), np.asarray(stats["mean"]),
          np.asarray(stats["var"])]


def test_grouped_batch_norm_matches_jax(spawned):
  """World 2, a group spanning both processes, against JAX's
  ``GroupedBatchNorm`` on the whole batch."""
  inp = td.ops_inputs()
  want = _jax_grouped_bn(inp["x"], inp["ct"], inp["scale"], inp["bias"])
  res = spawned["ops"]
  got = [_concat_rows(res, "grouped_bn", 0), _concat_rows(res, "grouped_bn",
                                                          1),
         sum(r["grouped_bn"][2] for r in res),
         sum(r["grouped_bn"][3] for r in res),
         res[0]["grouped_bn"][4], res[0]["grouped_bn"][5]]
  for i, (g, w) in enumerate(zip(got, want)):
    tol = 1e-4 * float(np.abs(w).max()) if i in (1, 2, 3) else 1e-6
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=tol, err_msg=str(i))


def test_grouped_batch_norm_eval_bf16_matches_jax():
  """Eval mode in bfloat16: normalized in float32 with the running
  averages, cast, then scale and bias in bfloat16, as JAX orders it."""
  from xmcgan_image_generation_tpu_torch.ops import normalization

  rng = np.random.default_rng(3)
  c = 16
  x = rng.normal(1.0, 3.0, (4, c, 5, 5)).astype(np.float32)
  mean, scale, bias = (rng.normal(size=c).astype(np.float32)
                       for _ in range(3))
  var = rng.uniform(0.5, 4.0, size=c).astype(np.float32)
  module = j_norm.GroupedBatchNorm(group_size=td.GROUP,
                                   use_running_average=True,
                                   dtype=jnp.bfloat16)
  y = module.apply(
      {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
       "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}},
      jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jnp.bfloat16))
  want = np.asarray(y.astype(jnp.float32)).transpose(0, 3, 1, 2)
  bn = normalization.GroupedBatchNorm(c, td.GROUP, dtype=torch.bfloat16,
                                      use_scale=True, use_bias=True).eval()
  with torch.no_grad():
    for name, value in (("mean", mean), ("var", var), ("scale", scale),
                        ("bias", bias)):
      getattr(bn, name).copy_(torch.from_numpy(value))
    got = bn(torch.from_numpy(x).to(torch.bfloat16))
  assert got.dtype == torch.bfloat16
  np.testing.assert_array_equal(got.float().numpy(), want)


def test_grouped_contrastive_heads_match_jax(spawned):
  inp = td.ops_inputs()
  res = spawned["ops"]

  @jax.jit
  def heads(fa, fb, region, word, max_len):
    """Both grouped heads' statistics and gradients, in one program."""
    def sentence(a, b):
      return j_contrastive.nt_xent(a, b, group_size=td.GROUP)

    def words(r):
      return j_attention.word_loss(r, word, max_len, group_size=td.GROUP)

    grads = jax.grad(lambda a, b: sentence(a, b)[0], argnums=(0, 1))(fa, fb)
    return (sentence(fa, fb), grads, words(region),
            (jax.grad(lambda r: words(r)[0])(region),))

  s_stats, s_grads, w_stats, w_grads = heads(
      *(jnp.asarray(inp[k]) for k in ("feat_a", "feat_b", "region", "word",
                                      "max_len")))
  for name, want_stats, grads in (("ntxent_group", s_stats, s_grads),
                                  ("word_group", w_stats, w_grads)):
    for r in res:
      np.testing.assert_allclose(np.array(r[name][:3]),
                                 np.array([float(v) for v in want_stats]),
                                 rtol=1e-5, atol=1e-6, err_msg=name)
    for i, want in enumerate(grads):
      want = np.asarray(want)
      np.testing.assert_allclose(_concat_rows(res, name, 3 + i), want,
                                 rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                 err_msg=name)


def test_sharded_word_scores(spawned):
  """Scores, d_region and d_word of ``make_sharded_word_scores`` at world
  2 against the port's one-process ``word_scores`` and against JAX's
  ``make_sharded_word_scores`` on a 2-device mesh (interpret mode)."""
  from xmcgan_image_generation_tpu_torch.ops.attention import padding_mask
  from xmcgan_image_generation_tpu_torch.ops.cuda import word_scores as ws

  inp = td.ops_inputs()
  res = spawned["ops"]
  mask = padding_mask(torch.from_numpy(inp["max_len"]),
                      inp["word"].shape[1])
  r = torch.from_numpy(inp["region"]).requires_grad_()
  w = torch.from_numpy(inp["word"]).requires_grad_()
  s = ws.word_scores(r, w, mask, GAMMA, GAMMA)
  s.backward(torch.from_numpy(inp["g"]))
  port = [s.detach().numpy(), r.grad.numpy(), w.grad.numpy()]

  mesh = create_mesh(2, 1, devices=jax.devices()[:2])
  fn = j_ws.make_sharded_word_scores(mesh, gamma1=GAMMA, gamma2=GAMMA,
                                     interpret=True)
  jm = jnp.asarray(mask.numpy())
  jr, jw = jnp.asarray(inp["region"]), jnp.asarray(inp["word"])
  scores, pullback = jax.vjp(lambda a, b: fn(a, b, jm), jr, jw)
  d_region, d_word = pullback(jnp.asarray(inp["g"]))
  jax_out = [np.asarray(scores), np.asarray(d_region), np.asarray(d_word)]

  got = [res[0]["sharded"][0], _concat_rows(res, "sharded", 1),
         _concat_rows(res, "sharded", 2)]
  np.testing.assert_array_equal(res[1]["sharded"][0], got[0])
  for want in (port, jax_out):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for g, wv in zip(got[1:], want[1:]):
      np.testing.assert_allclose(g, wv, rtol=1e-4,
                                 atol=1e-4 * np.abs(wv).max())


# ---------------------------------------------------------------------------
# The loader's shards against grain's.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workers,ranks,splits", [
    (0, (0, 1), ("train", "eval")), (2, (1,), ("train",))])
def test_loader_shards_match_grain(monkeypatch, workers, ranks, splits):
  """Process ``r``'s first 2 train super-batches (and eval batches) at
  world 2, bit for bit: the JAX package's ``create_datasets`` with
  grain's ``ShardOptions(shard_index=r, shard_count=2,
  drop_remainder=True)`` in place of ``ShardByJaxProcess`` (and
  ``jax.process_count`` of 2).  With 2 workers (whose processes import
  JAX, some seconds each) the second process's train loader."""
  import grain.python as pg

  monkeypatch.setattr(jax, "process_count", lambda: 2)
  for rank in ranks:
    monkeypatch.setattr(
        j_pipeline.pg, "ShardByJaxProcess", functools.partial(
            pg.ShardOptions, shard_index=rank, shard_count=2))
    j_config, config = j_coco_xmc.get_test_config(), coco_xmc.get_test_config()
    for c in (j_config, config):
      c.grain_worker_count = workers
      c.train_shuffle = True
      c.batch_size = 4
      c.eval_batch_size = 4
    j_train, j_eval, j_n = j_pipeline.create_datasets(j_config, seed=7)
    train, evaluation, n = pipeline.create_datasets(
        config, seed=7, process_index=rank, process_count=2)
    assert n == j_n
    pairs = {"train": (train, j_train), "eval": (evaluation, j_eval)}
    for split in splits:
      ours, theirs = pairs[split]
      it, j_it = iter(ours), iter(theirs)
      try:
        for _ in range(2):
          got, want = next(it), next(j_it)
          assert set(got) == set(want)
          for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
      finally:
        it.close()


def test_loader_rejects_indivisible_batches():
  config = coco_xmc.get_test_config()
  config.batch_size = 3
  with pytest.raises(ValueError, match="Global batch size 3 must be "
                                       "divisible by process count 2"):
    pipeline.create_datasets(config, seed=0, process_index=0,
                             process_count=2)
  config.batch_size, config.eval_batch_size = 4, 3
  with pytest.raises(ValueError, match="Eval batch size 3 must be "
                                       "divisible by process count 2"):
    pipeline.create_datasets(config, seed=0, process_index=1,
                             process_count=2)

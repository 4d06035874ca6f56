"""The port's multi-device serving artifact, and artifacts moved between
devices, against the JAX package's, on the CPU.

``export_generator(..., devices=["cpu"] * N)`` is the port's form of the
JAX package's ``export_generator(mesh=...)`` with a ``data`` axis of N
devices: one ``.pt2`` of the shard's program (B / N rows), its weights
once, and N and B recorded in the file.  It is saved and loaded back
with ``load_exported(path, devices=...)``, at B = 8 over 2 and 4
devices, with normal, EMA and int8 EMA weights, and for the spectral
reference-layout G (``g_spectral_norm=True``).  The weights are the JAX
initialization's of ``tests/test_torch_serving.py`` (random running
statistics, EMA weights apart from the normal ones).

Tolerances.  Against the port's own programs: bit for bit (the same
operations on the same rows; PyTorch's CPU kernels give a row the same
result at 2, 4 and 8 rows at this config).  Against the JAX package's
sharded artifact: ``tests/test_torch_serving.py``'s rules, with that
artifact as JAX's compiled program: float32 within 1e-4 relative and
1e-5 absolute of it and of JAX's serving function run op by op;
bfloat16 and int8 (computing in bfloat16) no further from the op-by-op
function than JAX's sharded artifact is (max |difference| no larger, at
least as many pixels equal), since compiling moves JAX's own bfloat16
images.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu.models import get_architecture as j_arch
from xmcgan_image_generation_tpu.utils import serving as j_serving
from xmcgan_image_generation_tpu_torch.models import xmc_net
from xmcgan_image_generation_tpu_torch.utils import bridge
from xmcgan_image_generation_tpu_torch.utils import serving

from test_torch_reference_layout import configs, g_batch, randomize_stats
from test_torch_serving import inputs, setup  # noqa: F401 (a fixture)

torch.set_num_threads(1)

BATCH = 8


def assert_near_jax(got: np.ndarray, eager: np.ndarray,
                    compiled: np.ndarray, dtype: str) -> None:
  """``got`` against JAX's serving function run op by op (``eager``) and
  its sharded artifact (``compiled``), by the module's rules."""
  assert got.shape == eager.shape and got.dtype == np.float32
  if dtype == "float32":
    for want in (eager, compiled):
      np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    return
  worst, jax_worst = (float(np.abs(a - eager).max())
                      for a in (got, compiled))
  equal, jax_equal = (float(np.mean(a == eager)) for a in (got, compiled))
  assert worst <= jax_worst and equal >= jax_equal, (
      f"against JAX's op-by-op serving function: max |diff| {worst} "
      f"({jax_worst} for JAX's sharded artifact), {equal:.4f} of pixels "
      f"equal ({jax_equal:.4f})")


def jax_sharded(gen, variables, j_config, n, quantize, x):
  """JAX's ``export_generator(mesh=...)`` over ``n`` devices, called on
  ``x`` placed by ``in_shardings_jax`` as its consumer places them."""
  mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("data",))
  exported = j_serving.export_generator(gen, variables, j_config,
                                        batch_size=BATCH, mesh=mesh,
                                        quantize=quantize)
  placed = tuple(jax.device_put(v, s)
                 for v, s in zip(x, exported.in_shardings_jax(mesh)))
  out = exported.call(*placed)
  assert len({sh.device.id for sh in out.addressable_shards}) == n
  return np.asarray(out)


def served_by_hand(path, x):
  """The artifact served as a consumer with nothing but ``torch`` serves
  it: its program on each chunk of the split ``sharding.json`` names,
  the images concatenated."""
  extra = {"sharding.json": ""}
  module = torch.export.load(path, extra_files=extra).module()
  sharding = json.loads(extra["sharding.json"])
  n, rows = sharding["num_devices"], sharding["shard_batch_size"]
  assert sharding["batch_size"] == n * rows == x[0].shape[0]
  return torch.cat([module(*(v[i * rows:(i + 1) * rows] for v in x))
                    for i in range(n)])


def static_reference(g, params, config, quantize, x):
  """The port's static-batch-8 artifact on ``x`` and its saved bytes, and
  ``ServingGenerator`` (eager G) on ``x`` whole."""
  buf = io.BytesIO()
  torch.export.save(serving.export_generator(
      g, params, config, batch_size=BATCH, quantize=quantize,
      device="cpu"), buf)
  buf.seek(0)
  images = torch.export.load(buf).module()(*x)
  with torch.no_grad():
    eager = serving.ServingGenerator(config, g, params,
                                     quantize=quantize)(*x)
  return images, len(buf.getvalue()), eager


def check_sharded(g, params, config, quantize, n, tmp_path, x, static):
  """The sharded artifact of ``n`` CPU devices, saved and loaded back,
  against the shard program by hand and eager G on each chunk, bit for
  bit; and against the static-batch-8 artifact (``static``): bit for bit
  where eager G gives the chunks' rows as it gives them in the whole
  batch (at B / N = 2, bfloat16, int8, it moves one row of eight by one
  ulp, 2^-8, on 0.5 % of its pixels).  Returns the images."""
  path = str(tmp_path / f"sharded{n}.pt2")
  exported = serving.export_generator(g, params, config, batch_size=BATCH,
                                      quantize=quantize,
                                      devices=["cpu"] * n)
  assert (exported.num_devices, exported.batch_size) == (n, BATCH)
  exported.save(path)
  static_images, static_bytes, eager = static
  # The weights are stored once: the file is no larger than one program's.
  assert os.path.getsize(path) <= static_bytes
  served = serving.load_exported(path, devices=["cpu"] * n)
  assert isinstance(served, serving.ShardedGenerator)
  got = served(*x)
  assert got.shape == (BATCH, config.image_size, config.image_size, 3)
  assert torch.equal(got, served_by_hand(path, x))
  module = serving.ServingGenerator(config, g, params, quantize=quantize)
  rows = BATCH // n
  with torch.no_grad():
    chunks = torch.cat([module(*(v[i * rows:(i + 1) * rows] for v in x))
                        for i in range(n)])
  assert torch.equal(got, chunks)
  assert torch.equal(static_images, eager)
  if torch.equal(chunks, eager):
    assert torch.equal(got, static_images)
  return got.numpy()


@pytest.fixture(scope="module")
def references():
  """What a case shares with the cases of other N: the static artifact's
  and eager G's images, and JAX's op-by-op serving function's, by
  weights."""
  return {}


@pytest.mark.parametrize("n,weights,quantize", [
    (2, "normal", None), (2, "ema", None), (2, "ema", "int8"),
    (4, "ema", None), (4, "ema", "int8")])
def test_sharded_artifact_matches_jax(setup, references, tmp_path,  # noqa: F811
                                      n, weights, quantize):
  s = setup
  config = s["config"]
  params = s["ema_t"] if weights == "ema" else None
  variables = dict(s["variables"], params=(
      s["ema"] if weights == "ema" else s["variables"]["params"]))
  x = inputs(config, BATCH, seed=20)
  xt = [torch.from_numpy(v) for v in x]
  key = (config.dtype, weights, quantize)
  if key not in references:
    serve = j_serving.generator_serving_fn(s["gen"], variables,
                                           s["j_config"], quantize=quantize)
    references[key] = (static_reference(s["g"], params, config, quantize,
                                        xt), np.asarray(serve(*x)))
  static, jax_eager = references[key]
  got = check_sharded(s["g"], params, config, quantize, n, tmp_path, xt,
                      static)
  assert_near_jax(got, jax_eager,
                  jax_sharded(s["gen"], variables, s["j_config"], n,
                              quantize, x), config.dtype)


@pytest.mark.parametrize("dtype,quantize", [
    ("float32", None), ("bfloat16", "int8")])
def test_sharded_spectral_generator(tmp_path, dtype, quantize):
  """The spectral reference-layout G: each served kernel normalized once
  by its power iteration, in the shard's program as in JAX's."""
  j_config, config = configs("spectral", dtype=dtype)
  gen, _ = j_arch(j_config, jnp.float32 if dtype == "float32"
                  else jnp.bfloat16)
  batch = g_batch(config, 2, seed=6)
  variables = randomize_stats(jax.device_get(gen(train=False).init(
      jax.random.PRNGKey(1), (batch, batch["z"]))))
  rng = np.random.default_rng(7)
  ema = jax.tree_util.tree_map(
      lambda x: (x + 0.02 * rng.standard_normal(x.shape)).astype(np.float32),
      variables["params"])
  g = xmc_net.Generator(config, generator=torch.Generator().manual_seed(0))
  bridge.load_jax_variables(g, variables)
  params = bridge.tree_to_torch(ema)
  x = inputs(config, BATCH, seed=21)
  xt = [torch.from_numpy(v) for v in x]
  got = check_sharded(g, params, config, quantize, 2, tmp_path, xt,
                      static_reference(g, params, config, quantize, xt))
  variables = dict(variables, params=ema)
  serve = j_serving.generator_serving_fn(gen, variables, j_config,
                                         quantize=quantize)
  assert_near_jax(got, np.asarray(serve(*x)),
                  jax_sharded(gen, variables, j_config, 2, quantize, x),
                  dtype)


@pytest.fixture(scope="module")
def small():
  """The port's test-config G (float32, its own initialization)."""
  _, config = configs("fused")
  g = xmc_net.Generator(config, generator=torch.Generator().manual_seed(0))
  return config, g.eval()


def test_sharded_export_rejects_bad_batch(small):
  """JAX's errors: a symbolic batch, a batch not divisible by the axis."""
  config, g = small
  with pytest.raises(ValueError, match="static batch_size"):
    serving.export_generator(g, None, config, devices=["cpu"] * 2)
  with pytest.raises(ValueError, match="not divisible"):
    serving.export_generator(g, None, config, batch_size=6,
                             devices=["cpu"] * 4)
  with pytest.raises(ValueError, match="device or devices"):
    serving.export_generator(g, None, config, batch_size=8, device="cpu",
                             devices=["cpu"] * 2)


def test_sharded_consumer_rejects_mismatch(small, tmp_path):
  """A consumer of another device count, a call at another batch, and
  ``devices`` for an artifact that is not sharded raise."""
  config, g = small
  path = str(tmp_path / "sharded.pt2")
  serving.export_generator(g, None, config, batch_size=BATCH,
                           devices=["cpu"] * 2).save(path)
  with pytest.raises(ValueError, match="sharded over 2 devices, got 4"):
    serving.load_exported(path, devices=["cpu"] * 4)
  served = serving.load_exported(path, devices=["cpu"] * 2)
  x = [torch.from_numpy(v) for v in inputs(config, 6, seed=1)]
  with pytest.raises(ValueError, match="serves a batch of 8, got 6"):
    served(*x)
  with pytest.raises(ValueError, match="device or devices"):
    serving.load_exported(path, "cpu", devices=["cpu"] * 2)
  plain = str(tmp_path / "plain.pt2")
  torch.export.save(serving.export_generator(g, None, config, device="cpu"),
                    plain)
  with pytest.raises(ValueError, match="not a sharded artifact"):
    serving.load_exported(plain, devices=["cpu"] * 2)
  # Without devices a sharded artifact is its shard's program.
  shard = serving.load_exported(path).module()
  x = [torch.from_numpy(v) for v in inputs(config, 4, seed=2)]
  assert shard(*x).shape == (4, 32, 32, 3)


@pytest.mark.parametrize("spectral,quantize", [(False, None),
                                               (True, "int8")])
def test_load_exported_moves_program(tmp_path, spectral, quantize):
  """``load_exported(path, device=...)``: onto the CPU it was traced on,
  the artifact's own images bit for bit; onto another device (``meta``,
  which the CPU has) everything the program holds or names moves: the
  weights, the int8 values, scales and sigmas, and the graph's device
  arguments (108 tensor-metadata asserts and an ``arange`` here)."""
  config = configs("spectral" if spectral else "fused",
                   dtype="bfloat16")[1]
  g = xmc_net.Generator(config, generator=torch.Generator().manual_seed(0))
  path = str(tmp_path / "g.pt2")
  torch.export.save(serving.export_generator(g.eval(), None, config,
                                             quantize=quantize,
                                             device="cpu"), path)
  x = [torch.from_numpy(v) for v in inputs(config, 3, seed=4)]

  def devices(program):
    named = [str(n.kwargs["device"]) for n in program.graph.nodes
             if "device" in n.kwargs]
    held = [str(t.device) for t in (*program.state_dict.values(),
                                    *program.constants.values())
            if isinstance(t, torch.Tensor)]
    return set(named), set(held), len(named)

  traced = serving.load_exported(path)
  named, held, count = devices(traced)
  assert named == held == {"cpu"} and count > 100
  want = traced.module()(*x)
  assert torch.equal(serving.load_exported(path, device="cpu").module()(*x),
                     want)
  moved = serving.load_exported(path, device="meta")
  assert devices(moved)[:2] == ({"meta"}, {"meta"})
  names = set(moved.state_dict)
  if quantize:
    assert any(k.endswith("kernel_int8") for k in names)
    assert any(k.endswith("kernel_sigma") for k in names)
  out = moved.module()(*(v.to("meta") for v in x))
  assert out.device.type == "meta" and out.shape == want.shape

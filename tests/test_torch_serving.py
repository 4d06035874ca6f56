"""The port's serving export against the JAX package's, on the CPU.

The same weights, made by the JAX generator's initialization (random
running statistics, and EMA weights that differ from the normal ones),
go into JAX's ``generator_serving_fn`` and, through ``utils/bridge.py``,
into the port's ``export_generator``, whose ``ExportedProgram`` is saved
and loaded back with ``torch.export.load`` as a consumer loads it.  One
symbolic-batch artifact serves batches of 1, 3 and 8.  At the test
config (32 px, width 16) and, once, at the flagship's full width.

Tolerances.  Float32: 1e-4 relative and 1e-5 absolute, as
``tests/test_torch_models.py`` holds G (XLA:CPU and PyTorch's convs sum
in other orders), against JAX's serving function run op by op and
compiled.  Bfloat16 and int8 (computing in bfloat16): compiling the
bfloat16 program moves JAX's own images, since XLA rounds to bfloat16 at
other places than the op-by-op run (at the test config a third to a half
of the pixels change, by up to 6 ulps of the top binade, 2^-8; at the
flagship's width more than half, by up to 14).  So the port's artifact
must be no further from JAX's op-by-op serving function than JAX's
compiled one is: max |difference| no larger, and at least as many pixels
equal.  The int8 weights themselves, and the port's artifact against its
own eager G: bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.models import get_architecture as j_arch
from xmcgan_image_generation_tpu.utils import serving as j_serving
from xmcgan_image_generation_tpu_torch import export_serving
from xmcgan_image_generation_tpu_torch import main as port_main
from xmcgan_image_generation_tpu_torch import serving_bench
from xmcgan_image_generation_tpu_torch import train
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.models import xmc_net
from xmcgan_image_generation_tpu_torch.ops.normalization import BatchNorm
from xmcgan_image_generation_tpu_torch.utils import bridge
from xmcgan_image_generation_tpu_torch.utils import checkpoint
from xmcgan_image_generation_tpu_torch.utils import serving

torch.set_num_threads(1)

BATCHES = (1, 3, 8)


def assert_matches_jax(got: np.ndarray, serve, x, dtype: str) -> None:
  """``got`` against JAX's serving function ``serve`` on inputs ``x``, run
  op by op and compiled, by the rules of the module's docstring."""
  eager = np.asarray(serve(*x))
  compiled = np.asarray(jax.jit(serve)(*x))
  assert got.shape == eager.shape and got.dtype == np.float32
  if dtype == "float32":
    for want in (eager, compiled):
      np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    return
  worst, jax_worst = (float(np.abs(a - eager).max()) for a in (got,
                                                                compiled))
  equal, jax_equal = (float(np.mean(a == eager)) for a in (got, compiled))
  assert worst <= jax_worst and equal >= jax_equal, (
      f"against JAX's op-by-op serving function: max |diff| {worst} "
      f"({jax_worst} for JAX's compiled one), {equal:.4f} of pixels equal "
      f"({jax_equal:.4f})")


def inputs(config, batch, seed):
  rng = np.random.default_rng(seed)
  return (rng.standard_normal((batch, 768)).astype(np.float32),
          rng.standard_normal((batch, 17, 768)).astype(np.float32),
          rng.integers(3, 18, (batch, 1)).astype(np.float32),
          rng.standard_normal((batch, config.z_dim)).astype(np.float32))


def _configs(dtype):
  j_config, config = j_coco_xmc.get_test_config(), coco_xmc.get_test_config()
  j_config.dtype = config.dtype = dtype
  return j_config, config


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def setup(request):
  """JAX's initialization of G at the test config in ``dtype``, with
  random running statistics and EMA weights; the port's G on the same
  normal weights and statistics, and the EMA weights bridged."""
  j_config, config = _configs(request.param)
  gen, _ = j_arch(j_config, jnp.float32 if request.param == "float32"
                  else jnp.bfloat16)
  batch = inputs(config, 2, 0)
  cond = dict(zip(("sentence_embedding", "embedding", "max_len"), batch))
  variables = jax.device_get(gen(train=False).init(
      jax.random.PRNGKey(1), (cond, batch[3])))
  rng = np.random.default_rng(5)
  variables["batch_stats"] = jax.tree_util.tree_map(
      lambda x: (x + rng.uniform(0.1, 0.5, x.shape)).astype(np.float32),
      variables["batch_stats"])
  ema = jax.tree_util.tree_map(
      lambda x: (x + 0.02 * rng.standard_normal(x.shape)).astype(np.float32),
      variables["params"])
  g = xmc_net.Generator(config, generator=torch.Generator().manual_seed(0))
  bridge.load_jax_variables(g, variables)
  return dict(j_config=j_config, config=config, gen=gen,
              variables=variables, ema=ema, g=g,
              ema_t=bridge.tree_to_torch(ema))


def _serve_port(s, weights, quantize, tmp_path):
  """The port's symbolic-batch artifact, saved and loaded back; returns
  the loaded module, the program and its file."""
  params = s["ema_t"] if weights == "ema" else None
  path = str(tmp_path / "generator.pt2")
  exported = serving.export_generator(s["g"], params, s["config"],
                                      quantize=quantize, device="cpu")
  torch.export.save(exported, path)
  return serving.load_exported(path).module(), exported, path


@pytest.mark.parametrize("weights,quantize", [
    ("normal", None), ("ema", None), ("ema", "int8")])
def test_artifact_matches_jax(setup, tmp_path, weights, quantize):
  s = setup
  served, _, _ = _serve_port(s, weights, quantize, tmp_path)
  params = s["ema"] if weights == "ema" else s["variables"]["params"]
  serve = j_serving.generator_serving_fn(
      s["gen"], dict(s["variables"], params=params), s["j_config"],
      quantize=quantize)
  for b in BATCHES:
    x = inputs(s["config"], b, seed=b)
    got = served(*(torch.from_numpy(v) for v in x))
    assert got.shape == (b, 32, 32, 3)
    assert_matches_jax(got.numpy(), serve, x, s["config"].dtype)


def test_artifact_is_eager_g(setup, tmp_path):
  """The artifact is G with the EMA weights, bit for bit, at every batch
  size; bfloat16 parameters halve a bfloat16 artifact, int8 kernels hold
  int8 values."""
  s = setup
  config, g = s["config"], s["g"]
  served, exported, path = _serve_port(s, "ema", None, tmp_path)
  dtype = xmc_net.compute_dtype(config)
  g.eval()
  for b in BATCHES:
    x = [torch.from_numpy(v) for v in inputs(config, b, seed=10 + b)]
    cond = dict(zip(("sentence_embedding", "embedding", "max_len"),
                    (v.to(dtype) for v in x)))
    with torch.no_grad():
      want = functional_call(g, s["ema_t"], (cond, x[3].to(dtype))).float()
    assert torch.equal(served(*x), want)
  assert {t.dtype for t in exported.state_dict.values()} == (
      {torch.float32} if config.dtype == "float32"
      else {torch.bfloat16, torch.float32})
  int8 = serving.export_generator(g, s["ema_t"], config, quantize="int8",
                                  device="cpu")
  assert {t.dtype for t in int8.state_dict.values()} == {torch.int8,
                                                         torch.float32}
  f32_config = coco_xmc.get_test_config()
  f32_config.dtype = "float32"
  f32_path = str(tmp_path / "f32.pt2")
  torch.export.save(serving.export_generator(g, s["ema_t"], f32_config,
                                             device="cpu"), f32_path)
  int8_path = str(tmp_path / "int8.pt2")
  torch.export.save(int8, int8_path)
  f32_bytes = os.path.getsize(f32_path)
  if config.dtype == "bfloat16":
    assert os.path.getsize(path) < 0.62 * f32_bytes
  assert os.path.getsize(int8_path) < 0.4 * f32_bytes


def test_quantize_int8_matches_jax(setup):
  """The int8 values, their scales and the dequantized kernels equal
  JAX's bit for bit after the bridge; biases pass through."""
  s = setup
  params = s["variables"]["params"]
  leaves, treedef = j_serving.quantize_params_int8(params)
  j_q = jax.tree_util.tree_unflatten(treedef, [q for q, _ in leaves])
  j_deq = jax.device_get(j_serving._dequantize_params((leaves, treedef),
                                                      jnp.float32))
  port = serving.quantize_params_int8(bridge.tree_to_torch(params))
  got_q = bridge.tensors_to_jax({n: q for n, (q, _) in port.items()})
  got_deq = bridge.tensors_to_jax({
      n: q if scale is None else serving.dequantize(q, scale, torch.float32)
      for n, (q, scale) in port.items()})
  flat_q, flat_deq = bridge.flatten(got_q), bridge.flatten(got_deq)
  want_q = bridge.flatten(jax.device_get(j_q))
  quantized = [n for n, (_, scale) in port.items() if scale is not None]
  assert quantized and all(n.endswith("kernel") for n in quantized)
  for name, want in bridge.flatten(j_deq).items():
    np.testing.assert_array_equal(flat_deq[name], np.asarray(want),
                                  err_msg=name)
    np.testing.assert_array_equal(flat_q[name],
                                  np.asarray(want_q[name], np.float32),
                                  err_msg=name)


@pytest.mark.parametrize("batch_size,quantize", [(None, None), (4, "int8")])
def test_metadata_matches_jax(batch_size, quantize):
  j_config, config = _configs("bfloat16")
  want = json.loads(j_serving.artifact_metadata(
      j_config, weights="ema", step=12, batch_size=batch_size,
      quantize=quantize))
  got = json.loads(serving.artifact_metadata(
      config, weights="ema", step=12, batch_size=batch_size, device="cpu",
      quantize=quantize))
  assert got.pop("platforms") == ["cpu", "cuda"]
  want.pop("platforms")
  assert got == want


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
  """A workdir with one checkpoint, written by the port's training loop on
  the CPU at the test config."""
  root = str(tmp_path_factory.mktemp("run"))
  config = coco_xmc.get_test_config()
  config.num_train_steps = 1
  train.train(config, root, "cpu")
  return root


def _eager_ema(config, workdir, x):
  manager = checkpoint.CheckpointManager(checkpoint.checkpoints_dir(workdir))
  state = manager.restore(manager.latest_step(),
                          create_train_state(config, "cpu", seed=config.seed))
  with torch.no_grad():
    return serving.ServingGenerator(config, state.generator,
                                    state.ema_params)(*x)


def test_export_mode_from_workdir(workdir):
  """``main --mode=export`` writes the EMA artifact and its sidecar; the
  artifact is the restored EMA G."""
  port_main.main(["--workdir", workdir, "--config=test", "--mode=export",
                  "--device=cpu"])
  base = os.path.join(workdir, "serving", "generator_ema_step00000001")
  with open(base + ".json") as f:
    meta = json.load(f)
  assert meta["weights"] == "ema" and meta["step"] == 1
  assert meta["platforms"] == ["cpu", "cuda"]
  assert meta["quantization"] == "none"
  config = coco_xmc.get_test_config()
  x = [torch.from_numpy(v) for v in inputs(config, 3, seed=7)]
  got = torch.export.load(base + ".pt2").module()(*x)
  assert torch.equal(got, _eager_ema(config, workdir, x))


def test_export_serving_both_int8(workdir, tmp_path):
  export_serving.main(["--workdir", workdir, "--config_module=coco_xmc:test",
                       "--weights=both", "--quantize=int8", "--batch_size=2",
                       "--device=cpu", "--out", str(tmp_path)])
  names = sorted(os.listdir(tmp_path))
  assert names == [f"generator_{w}_int8_step00000001.{e}"
                   for w in ("ema", "normal") for e in ("json", "pt2")]
  with open(tmp_path / names[0]) as f:
    meta = json.load(f)
  assert meta["quantization"] == "int8" and meta["inputs"]["z"] == [2, 8]


def test_no_card_no_fallback(workdir, monkeypatch, capsys):
  """Without a card, export and the bench raise unless asked for the
  CPU; the bench runs on the CPU when asked."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    port_main.main(["--workdir", workdir, "--config=test", "--mode=export"])
  with pytest.raises(RuntimeError, match="no CUDA device"):
    serving_bench.main(["--config_module=coco_xmc:test"])
  serving_bench.main(["--config_module=coco_xmc:test", "--workdir", workdir,
                      "--batch_sizes=1,2", "--steps=1", "--windows=2",
                      "--sizes", "--device=cpu"])
  result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert result["device"] == "cpu" and result["checkpoint_step"] == 1
  for b in ("1", "2"):
    assert len(result["batches"][b]["artifact_ms_windows"]) == 2
    assert result["batches"][b]["artifact_max_abs_dev_vs_eager"] == 0.0
  sizes = result["sizes"]["artifact_bytes"]
  assert sizes["int8"] < sizes["bf16"] < sizes["f32"]


def _calibrated_flagship_g(config):
  """The flagship G at its initialization (seed 0), EMA weights near it,
  and running statistics taken from one train-mode batch of the EMA net:
  with an initialization's statistics (0 and 1) the activations grow
  through the blocks and 97 % of the pixels saturate at 0 or 1."""
  g = xmc_net.Generator(config, generator=torch.Generator().manual_seed(0))
  rng = np.random.default_rng(0)
  ema = {n: p.detach() + 0.01 * torch.from_numpy(
      rng.standard_normal(tuple(p.shape), np.float32))
         for n, p in g.named_parameters()}
  norms = [m for m in g.modules() if isinstance(m, BatchNorm)]
  for m in norms:
    m.momentum = 0.0
  x = [torch.from_numpy(v) for v in inputs(config, 8, seed=9)]
  cond = dict(zip(("sentence_embedding", "embedding", "max_len"), x))
  with torch.no_grad():
    functional_call(g, ema, (cond, x[3]))
  for m in norms:
    m.momentum = 0.9
  return g.eval(), ema


def test_flagship_full_width_bf16_ema(tmp_path):
  """``configs/coco_xmc.py`` at full width (128 px, ``gf_dim`` 96,
  78,507,779 parameters, bfloat16): the EMA artifact against JAX's
  serving function at batch 2."""
  config, j_config = coco_xmc.get_config(), j_coco_xmc.get_config()
  g, ema = _calibrated_flagship_g(config)
  assert sum(p.numel() for p in g.parameters()) == 78_507_779
  path = str(tmp_path / "flagship.pt2")
  torch.export.save(serving.export_generator(g, ema, config, device="cpu"),
                    path)
  x = inputs(config, 2, seed=3)
  got = serving.load_exported(path).module()(
      *(torch.from_numpy(v) for v in x)).numpy()
  variables = {"params": bridge.tensors_to_jax(ema),
               "batch_stats": bridge.jax_from_state_dict(
                   dict(g.named_buffers()))["batch_stats"]}
  del g, ema
  gen, _ = j_arch(j_config, jnp.bfloat16)
  assert got.shape == (2, 128, 128, 3)
  assert np.mean((got == 0) | (got == 1)) < 0.5   # mostly not saturated
  assert_matches_jax(got, j_serving.generator_serving_fn(gen, variables,
                                                         j_config),
                     x, "bfloat16")

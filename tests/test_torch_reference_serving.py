"""Serving, sampling and checkpoints of the port's reference-layout
generator against the JAX package's.

The spectral reference G (``g_spectral_norm=True``; the layouts and the
helpers are ``tests/test_torch_reference_layout.py``'s) at the test
config (32 px, width 16):

* `utils.serving.ServingGenerator` with EMA weights in float32, bfloat16
  and int8 against JAX's ``generator_serving_fn``: each spectral layer
  normalizes the kernel it serves (bfloat16-rounded, or dequantized from
  int8) by its power iteration in float32 from G's stored ``u0``, which
  it does not write (once, when the module is built);
* ``engine.sampling.generate_batch`` with EMA weights: eval mode, G's own
  ``u0`` and running averages, none written;
* a checkpoint round trip and a resume, with G's ``u0``.

Tolerances: ``tests/test_torch_serving.py``'s rules: float32 1e-4
relative and 1e-5 absolute against JAX's serving function run op by op
and compiled; bfloat16 (also for int8 weights in a bfloat16 config) no
further from JAX's op-by-op serving function than JAX's compiled one
(max |difference| no larger, at least as many pixels equal), since
compiling moves JAX's own bfloat16 images.  Sampling and resume: bit for
bit (PyTorch's CPU kernels are deterministic for a fixed thread count).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from xmcgan_image_generation_tpu.models import get_architecture as j_arch
from xmcgan_image_generation_tpu.utils import serving as j_serving
from xmcgan_image_generation_tpu_torch import train as train_lib
from xmcgan_image_generation_tpu_torch.engine import sampling
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.models import xmc_net
from xmcgan_image_generation_tpu_torch.utils import bridge
from xmcgan_image_generation_tpu_torch.utils import checkpoint
from xmcgan_image_generation_tpu_torch.utils import serving

from test_torch_reference_layout import configs, g_batch, randomize_stats
from test_torch_reference_layout import tensors

torch.set_num_threads(1)


def assert_matches_jax(got: np.ndarray, serve, x, dtype: str) -> None:
  """``got`` against JAX's serving function, by the module's rules."""
  eager = np.asarray(serve(*x))
  compiled = np.asarray(jax.jit(serve)(*x))
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
      f"({jax_worst} for JAX's compiled one), {equal:.4f} of pixels equal "
      f"({jax_equal:.4f})")


@pytest.mark.parametrize("dtype,quantize", [
    ("float32", None), ("bfloat16", None), ("float32", "int8"),
    ("bfloat16", "int8")])
def test_serving_spectral_generator(dtype, quantize):
  """The spectral G served with EMA weights: each spectral layer
  normalizes the kernel it serves (bfloat16-rounded, or dequantized from
  int8) from G's stored ``u0``, which stays as it was."""
  j_config, config = configs("spectral", dtype=dtype)
  gen, _ = j_arch(j_config, jnp.float32 if dtype == "float32"
                  else jnp.bfloat16)
  batch = g_batch(config, 3, seed=6)
  variables = randomize_stats(jax.device_get(gen(train=False).init(
      jax.random.PRNGKey(1), (batch, batch["z"]))))
  rng = np.random.default_rng(7)
  ema = jax.tree_util.tree_map(
      lambda x: (x + 0.02 * rng.standard_normal(x.shape)).astype(np.float32),
      variables["params"])
  g = xmc_net.Generator(config, generator=torch.Generator().manual_seed(0))
  bridge.load_jax_variables(g, variables)
  u0 = {k: v.clone() for k, v in g.state_dict().items()
        if k.endswith("u0")}
  assert len(u0) > 20
  module = serving.ServingGenerator(config, g, bridge.tree_to_torch(ema),
                                    quantize=quantize)
  # sigma is computed once: the served module holds no u0.
  assert not any(k.endswith("u0") for k in module.state_dict())
  x = tuple(batch[k] for k in serving.INPUTS)
  got = module(*(torch.from_numpy(v) for v in x)).numpy()
  serve = j_serving.generator_serving_fn(
      gen, dict(variables, params=ema), j_config, quantize=quantize)
  assert_matches_jax(got, serve, x, dtype)
  for k, v in u0.items():
    torch.testing.assert_close(g.state_dict()[k], v, rtol=0, atol=0)


# --- sampling and checkpoints ----------------------------------------------


def test_sampling_reads_g_state_and_writes_none():
  """``generate_batch`` with the EMA weights: eval mode, G's own ``u0``
  and running averages, none of them written."""
  _, config = configs("spectral")
  state = create_train_state(config, "cpu", seed=0)
  g = state.generator
  with torch.no_grad():
    for name, b in g.named_buffers():
      b.add_(0.1)
    for v in state.ema_params.values():
      v.mul_(1.01)
  before = {k: v.clone() for k, v in g.state_dict().items()}
  batch = tensors(g_batch(config, 3))
  batch["image"] = torch.zeros((3, 32, 32, 3), dtype=torch.uint8)
  out = sampling.generate_batch(state, batch, config)
  for k, v in g.state_dict().items():
    torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
  assert g.training
  g.eval()
  with torch.no_grad():
    want = functional_call(g, state.ema_params, (batch, batch["z"]))
    normal = g(batch, batch["z"])
  torch.testing.assert_close(out["ema_generated_image"], want, rtol=0,
                             atol=0)
  torch.testing.assert_close(out["generated_image"], normal, rtol=0,
                             atol=0)
  assert float((want - normal).abs().max()) > 0


def _spectral_config(steps):
  _, config = configs("spectral")
  config.num_train_steps = steps
  return config


def _all_tensors(state):
  out = {f"g.{k}": v for k, v in state.generator.state_dict().items()}
  out.update({f"d.{k}": v
              for k, v in state.discriminator.state_dict().items()})
  out.update({f"ema.{k}": v for k, v in state.ema_params.items()})
  for net, opt in (("g", state.g_opt), ("d", state.d_opt)):
    for i, slots in opt.state_dict()["state"].items():
      out.update({f"{net}_opt.{i}.{k}": v for k, v in slots.items()})
  return out


def test_checkpoint_round_trip_and_resume_with_g_u0(tmp_path):
  """The spectral reference G's ``u0`` is saved and restored with the
  rest of the state, and a run resumed after step 1 ends step 2 as an
  uninterrupted run does, bit for bit."""
  whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
  want = train_lib.train(_spectral_config(2), whole, "cpu")
  train_lib.train(_spectral_config(1), parts, "cpu")
  restored = create_train_state(_spectral_config(1), "cpu", seed=11)
  manager = checkpoint.CheckpointManager(checkpoint.checkpoints_dir(parts))
  manager.restore(1, restored)
  g_u0 = [k for k in restored.generator.state_dict() if k.endswith("u0")]
  assert len(g_u0) > 20
  got = train_lib.train(_spectral_config(2), parts, "cpu")
  a, b = _all_tensors(got), _all_tensors(want)
  assert got.step == want.step == 2 and set(a) == set(b)
  for name in b:
    torch.testing.assert_close(a[name], b[name], rtol=0, atol=0, msg=name)
  # The restored u0 is step 1's: step 2's joint update moved it once more.
  for k in g_u0:
    assert not torch.equal(restored.generator.state_dict()[k],
                           got.generator.state_dict()[k]), k

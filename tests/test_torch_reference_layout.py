"""The reference-layout generator of the port against the JAX package's.

G has three layouts, chosen by the JAX package's rule
``fused_spatial_cond and not g_spectral_norm``: ``fused`` (the default),
``reference`` (``fused_spatial_cond=False``: the concatenated, upsampled
conditioning map, `GenSpatialBlock`, `LocalConditionalBatchNorm`) and
``spectral`` (``g_spectral_norm=True``, which takes the reference layout
though ``fused_spatial_cond`` stays True, with every G conv and dense
spectrally normalized).  The same numpy-seeded inputs and the JAX
initialization's weights (carried across by `utils/bridge.py`, which maps
by flax's names, so the names are checked too) go through both
packages, in float32:

* `LocalConditionalBatchNorm`, `GenSpatialBlock` (both scale-fusion
  orders) and `DiscBlockDeep`, plain and spectral;
* G in train and eval mode, in each layout, with the scale-fused dilated
  up-convs and without, at 32 px (the test config): images and the new
  state (running averages and G's ``u0``); at 64 px in
  ``tests/test_torch_reference_step.py``;
* the port's reference G against its fused G on kernels split by
  `utils/reference_bridge.split_modulation_kernels`;
* remat "full" and "conv" of the spectral G against no remat.

Serving, sampling and checkpoints of the reference layout are in
``tests/test_torch_reference_serving.py``.

Tolerances: those of ``tests/test_torch_models.py`` (XLA:CPU and
PyTorch's CPU convs sum in other orders through a dozen layers): 1e-4
relative and 1e-5 absolute on images and state.  The fused and the
reference layout are the same function in exact arithmetic, with the
1x1 modulation convs summed in another order: 1e-5 absolute on images in
[0, 1].  Remat "full" recomputes the same float32 operations: bit for
bit, and "conv" within ``tests/test_torch_remat.py``'s 1e-6 relative on
values and 1e-3 relative plus 1e-4 (1 + max|g|) on gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.models import blocks as j_blocks
from xmcgan_image_generation_tpu.models import get_architecture as j_arch
from xmcgan_image_generation_tpu.models import xmc_net as j_xmc_net
from xmcgan_image_generation_tpu.ops import normalization as j_norm
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.models import blocks
from xmcgan_image_generation_tpu_torch.models import xmc_net
from xmcgan_image_generation_tpu_torch.ops import normalization
from xmcgan_image_generation_tpu_torch.ops.spectral_norm import (
    power_iteration_normalize,
)
from xmcgan_image_generation_tpu_torch.utils import bridge
from xmcgan_image_generation_tpu_torch.utils import reference_bridge

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
MUTABLE = ["batch_stats", "spectral_norm_stats"]
LAYOUTS = {
    "fused": dict(fused_spatial_cond=True, g_spectral_norm=False),
    "reference": dict(fused_spatial_cond=False, g_spectral_norm=False),
    "spectral": dict(fused_spatial_cond=True, g_spectral_norm=True),
}
SCALE_FUSE = {"unfused": dict(scale_fused_convs=False),
              "dilated": dict(scale_fused_convs=True,
                              upconv_method="dilated")}


def configs(layout="spectral", scale_fuse="dilated", image_size=32,
            dtype="float32", **overrides):
  """(JAX config, port config) of the test config with the overrides."""
  out = []
  for config in (j_coco_xmc.get_test_config(), coco_xmc.get_test_config()):
    config.dtype = dtype
    config.image_size = image_size
    for k, v in {**LAYOUTS[layout], **SCALE_FUSE[scale_fuse],
                 **overrides}.items():
      setattr(config, k, v)
    out.append(config)
  return tuple(out)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
  if isinstance(got, torch.Tensor):
    got = got.detach().float().numpy()
  np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                             atol=atol, err_msg=msg)


def close_state(module, new, rtol=RTOL, atol=ATOL):
  """``module``'s running averages and ``u0`` against JAX's new
  collections ``new``; returns the collections compared."""
  got = bridge.jax_from_state_dict(module.state_dict())
  seen = []
  for collection in MUTABLE:
    if collection not in new:
      assert collection not in got
      continue
    want = bridge.flatten(jax.device_get(new[collection]))
    have = bridge.flatten(got[collection])
    assert set(have) == set(want), collection
    for name, value in want.items():
      close(have[name], value, rtol, atol, msg=f"{collection}/{name}")
    seen.append(collection)
  return seen


def randomize_stats(variables, seed=5):
  """Non-trivial running averages, so that eval mode is exercised."""
  rng = np.random.default_rng(seed)
  out = dict(variables)
  out["batch_stats"] = jax.tree_util.tree_map(
      lambda x: (x + rng.uniform(0.1, 0.5, x.shape)).astype(np.float32),
      variables["batch_stats"])
  return out


def g_batch(config, n, seed=0):
  rng = np.random.default_rng(seed)
  return {
      "embedding": rng.standard_normal((n, 17, 768)).astype(np.float32),
      "sentence_embedding": rng.standard_normal((n, 768)).astype(np.float32),
      "max_len": rng.integers(3, 18, (n, 1)).astype(np.float32),
      "z": rng.standard_normal((n, config.z_dim)).astype(np.float32),
  }


def tensors(batch):
  return {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}


def nchw(x):
  return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(x):
  return x.detach().permute(0, 2, 3, 1).numpy()


# --- the layers ------------------------------------------------------------


def _factories(spectral, train):
  j_config, _ = configs()
  conv_fn, dense_fn = j_xmc_net._layer_factories(
      spectral, train, jnp.float32, up_method="dilated")
  return conv_fn, dense_fn, j_xmc_net._make_norm_fn(j_config, train,
                                                    jnp.float32)


def _module_case(j_module, port, inputs, train):
  """Initializes ``j_module`` on ``inputs`` (NHWC), loads its variables
  into ``port`` and runs both in ``train`` mode; returns (port output,
  JAX output, JAX's new collections)."""
  variables = jax.device_get(j_module.init(jax.random.PRNGKey(3), *inputs))
  if "batch_stats" in variables:
    variables = randomize_stats(variables)
  want, new = j_module.apply(variables, *inputs, mutable=MUTABLE)
  bridge.load_jax_variables(port, variables)
  port.train(train)
  got = port(*(nchw(x) for x in inputs))
  return got, want, new


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("spectral", [False, True],
                         ids=["plain", "spectral"])
def test_local_conditional_batch_norm(spectral, train):
  conv_fn, _, norm_fn = _factories(spectral, train)
  rng = np.random.default_rng(1)
  x = rng.standard_normal((4, 8, 8, 6)).astype(np.float32)
  emb = rng.standard_normal((4, 8, 8, 10)).astype(np.float32)
  port = normalization.LocalConditionalBatchNorm(
      6, 10, spectral=spectral, dtype=torch.float32)
  prefix = "SpectralConv" if spectral else "Conv"
  assert [n for n, _ in port.named_children()] == [
      f"{prefix}_0", f"{prefix}_1", "BatchNorm_0"]
  got, want, new = _module_case(
      j_norm.LocalConditionalBatchNorm(norm_fn=norm_fn, conv_fn=conv_fn),
      port, (x, emb), train)
  close(nhwc(got), want)
  assert close_state(port, new) == (
      ["batch_stats", "spectral_norm_stats"] if spectral
      else ["batch_stats"])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("scale_fuse", [False, True],
                         ids=["unfused", "scale_fused"])
@pytest.mark.parametrize("spectral", [False, True],
                         ids=["plain", "spectral"])
def test_gen_spatial_block(spectral, scale_fuse, train):
  """Both orders of the scale fusion: the upsample folded into ``Conv_0``
  and the shortcut's 1x1 conv before its upsample, or neither."""
  conv_fn, dense_fn, norm_fn = _factories(spectral, train)
  rng = np.random.default_rng(2)
  x = rng.standard_normal((4, 8, 8, 12)).astype(np.float32)
  cond_in = rng.standard_normal((4, 8, 8, 10)).astype(np.float32)
  cond_out = np.repeat(np.repeat(cond_in, 2, axis=1), 2, axis=2)
  port = blocks.GenSpatialBlock(12, 6, 10, scale_fuse=scale_fuse,
                                spectral=spectral, dtype=torch.float32)
  j_block = j_blocks.GenSpatialBlock(
      6, conv_fn=conv_fn, dense_fn=dense_fn, norm_fn=norm_fn,
      scale_fuse=scale_fuse)
  got, want, new = _module_case(j_block, port, (x, cond_in, cond_out),
                                train)
  assert got.shape == (4, 6, 16, 16)
  close(nhwc(got), want)
  close_state(port, new)


@pytest.mark.parametrize("downsample", [False, True],
                         ids=["same_size", "downsample"])
@pytest.mark.parametrize("spectral", [False, True],
                         ids=["plain", "spectral"])
def test_disc_block_deep(spectral, downsample):
  """The BigGAN-deep block, its channel-growing shortcut included (8 ->
  16 channels), in train mode (``u0`` advances)."""
  conv_fn, _, _ = _factories(spectral, True)
  x = np.random.default_rng(3).standard_normal((2, 8, 8, 8)).astype(
      np.float32)
  port = blocks.DiscBlockDeep(8, 16, downsample, spectral=spectral,
                              dtype=torch.float32)
  assert [n for n, _ in port.named_children()] == [
      "conv0", "conv1", "conv2", "conv3", "conv_sc"]
  got, want, new = _module_case(
      j_blocks.DiscBlockDeep(16, downsample, conv_fn=conv_fn), port, (x,),
      True)
  assert got.shape == (2, 16) + ((4, 4) if downsample else (8, 8))
  close(nhwc(got), want)
  assert close_state(port, new) == (["spectral_norm_stats"] if spectral
                                    else [])


# --- the generator ---------------------------------------------------------


def _jax_generator(layout, scale_fuse, image_size):
  j_config, config = configs(layout, scale_fuse, image_size)
  batch = g_batch(config, 4)
  gen, _ = j_arch(j_config, jnp.float32)
  variables = randomize_stats(jax.device_get(gen(train=False).init(
      jax.random.PRNGKey(1), (batch, batch["z"]))))
  return dict(config=config, gen=gen, variables=variables, batch=batch)


@pytest.fixture(scope="module", params=[
    (layout, fuse) for layout in LAYOUTS for fuse in SCALE_FUSE],
    ids=lambda p: f"{p[0]}-{p[1]}")
def generator32(request):
  return _jax_generator(*request.param, 32)


def _generator_case(s, train):
  want, new = s["gen"](train=train).apply(
      s["variables"], (s["batch"], s["batch"]["z"]), mutable=MUTABLE)
  g = xmc_net.Generator(s["config"],
                        generator=torch.Generator().manual_seed(0))
  bridge.load_jax_variables(g, s["variables"])
  g.train(train)
  batch = tensors(s["batch"])
  got = g(batch, batch["z"])
  size = s["config"].image_size
  assert got.shape == (4, size, size, 3)
  close(got, want)
  seen = close_state(g, new)
  config = s["config"]
  assert g.fused == (config.fused_spatial_cond
                     and not config.g_spectral_norm)
  assert ("spectral_norm_stats" in seen) == bool(config.g_spectral_norm)
  names = [n for n, _ in g.named_children()]
  spatial = "GenSpatialBlockFused_0" if g.fused else "GenSpatialBlock_0"
  assert spatial in names
  if config.g_spectral_norm:
    assert {"SpectralDense_0", "SpectralDense_1", "SpectralConv_0",
            "SpectralConv_1", "LocalConditionalBatchNorm_0"} <= set(names)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_generator(generator32, train):
  _generator_case(generator32, train)


@pytest.mark.parametrize("scale_fuse", list(SCALE_FUSE))
def test_reference_equals_fused_on_split_kernels(scale_fuse):
  """The port's reference G and its fused G, whose weights are the
  reference G's with each modulation kernel split, give the same images
  in train and eval mode."""
  _, ref_config = configs("reference", scale_fuse)
  _, fused_config = configs("fused", scale_fuse)
  ref = xmc_net.Generator(ref_config,
                          generator=torch.Generator().manual_seed(0))
  with torch.no_grad():
    for name, b in ref.named_buffers():
      b.add_(torch.rand(b.shape, generator=torch.Generator().manual_seed(
          len(name))) * 0.4 + 0.1)
  variables = bridge.jax_from_state_dict(ref.state_dict())
  fused = xmc_net.Generator(fused_config, device="meta")
  fused.to_empty(device="cpu")
  bridge.load_jax_variables(fused, {
      "params": reference_bridge.split_modulation_kernels(
          variables["params"]),
      "batch_stats": reference_bridge.rename_state_for_fused(
          variables["batch_stats"])})
  batch = tensors(g_batch(ref_config, 4))
  for train in (True, False):
    ref.train(train)
    fused.train(train)
    with torch.no_grad():
      close(fused(batch, batch["z"]), ref(batch, batch["z"]).numpy(),
            rtol=0, atol=1e-5)


@pytest.mark.parametrize("policy", ["full", "conv"])
def test_remat_of_the_spectral_generator(policy):
  """Remat of every block of the spectral reference G: the images and
  parameter gradients of no remat, ``u0`` advanced once (one power step
  from its start) and the running averages written once."""
  _, config = configs("spectral")
  batch = tensors(g_batch(config, 4))
  weight = torch.from_numpy(np.random.default_rng(4).standard_normal(
      (4, 32, 32, 3)).astype(np.float32))
  runs = []
  for overrides in ({}, dict(remat=True, remat_min_resolution=0,
                             remat_policy=policy)):
    _, cfg = configs("spectral", **overrides)
    g = xmc_net.Generator(cfg, generator=torch.Generator().manual_seed(0))
    start = {n: m.u0.clone() for n, m in g.named_modules()
             if getattr(m, "spectral", False)}
    g.train()
    images = g(batch, batch["z"])
    grads = torch.autograd.grad((images * weight).sum(),
                                list(g.parameters()))
    runs.append((g, images.detach(), grads, start))
  (plain, images, grads, start), (g, r_images, r_grads, _) = runs
  assert [n for n, m in g.named_children()
          if getattr(m, "remat_policy", None)] == [
              "GenBlock_0", "GenBlock_1", "GenSpatialBlock_0"]
  if policy == "full":
    torch.testing.assert_close(r_images, images, rtol=0, atol=0)
    for got, want in zip(r_grads, grads):
      torch.testing.assert_close(got, want, rtol=0, atol=0)
  else:
    torch.testing.assert_close(r_images, images, rtol=1e-6, atol=0)
    for got, want in zip(r_grads, grads):
      torch.testing.assert_close(
          got, want, rtol=1e-3, atol=1e-4 * (1 + float(want.abs().max())))
  layers = dict(g.named_modules())
  for name, u0 in start.items():
    layer = layers[name]
    _, once = power_iteration_normalize(layer._kernel_2d(layer.kernel), u0)
    torch.testing.assert_close(layer.u0, once, rtol=0, atol=0, msg=name)
  for (k, v), (k2, w) in zip(g.state_dict().items(),
                             plain.state_dict().items()):
    assert k == k2
    torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)

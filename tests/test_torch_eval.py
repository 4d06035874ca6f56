"""The port's evaluation path against the JAX package's, on the CPU.

Same numpy-seeded inputs (and, for the networks, the same weights through
`utils.bridge`) into both packages: the two-pass SAME average pool,
InceptionV3, the Inception feature function, the FID and IS statistics,
and sampling with normal and EMA weights.  Then the port's evaluation
service end to end on a test-config workdir.

Tolerances, float32 on both sides unless a test says otherwise (XLA:CPU
and PyTorch sum in other orders): 1e-5 relative and 1e-6 absolute for
single ops; 1e-4 of the largest magnitude for a whole network (InceptionV3
is 94 layers deep); the host statistics are float64 on both sides from
the same float32 pools, 1e-9 relative.
"""

import csv
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.engine import create_train_state as j_state
from xmcgan_image_generation_tpu.engine import sampling as j_sampling
from xmcgan_image_generation_tpu.models.inception_v3 import (
    InceptionV3 as JInceptionV3,
)
from xmcgan_image_generation_tpu.ops import pooling as j_pooling
from xmcgan_image_generation_tpu.utils import eval_metrics as j_eval_metrics
from xmcgan_image_generation_tpu.utils import fid as j_fid
from xmcgan_image_generation_tpu.utils import inception_weights as j_weights
from xmcgan_image_generation_tpu_torch import evaluate
from xmcgan_image_generation_tpu_torch import train as train_lib
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.engine import sampling
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.models.inception_v3 import InceptionV3
from xmcgan_image_generation_tpu_torch.ops import pooling
from xmcgan_image_generation_tpu_torch.utils import bridge
from xmcgan_image_generation_tpu_torch.utils import eval_metrics
from xmcgan_image_generation_tpu_torch.utils import fid
from xmcgan_image_generation_tpu_torch.utils import inception_weights

torch.set_num_threads(1)


def _close(got, want, rtol=1e-5, atol=1e-6):
  if isinstance(got, torch.Tensor):
    got = got.detach().float().numpy()
  np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                             atol=atol)


@pytest.mark.parametrize("size,window,stride", [
    ((5, 5), (3, 3), (1, 1)),
    ((7, 9), (3, 3), (2, 2)),
    ((5, 6), (2, 2), (2, 2)),
    ((35, 35), (3, 3), (1, 1)),
])
def test_tf_avg_pool_same_matches_jax(size, window, stride):
  """The two-pass SAME form on sizes where windows overlap padding."""
  x = np.random.default_rng(0).standard_normal((2, *size, 3)).astype(
      np.float32)
  want = j_pooling.tf_avg_pool(x, window, stride, "SAME")
  got = pooling.tf_avg_pool(bridge.nhwc_to_nchw(torch.from_numpy(x)),
                            window, stride, "SAME")
  _close(bridge.nchw_to_nhwc(got), want)


@functools.lru_cache(maxsize=None)
def _inception_weights():
  """The port's seeded init with BatchNorm statistics and biases moved off
  their init values, so that eval-mode BatchNorm is exercised; in the JAX
  ``.npz`` layout."""
  flat = bridge.flat_from_state_dict(InceptionV3().state_dict())
  rng = np.random.default_rng(1)
  for key, value in flat.items():
    if key.endswith(("/mean", "/bias")):
      flat[key] = (0.1 * rng.standard_normal(value.shape)).astype(np.float32)
    elif key.endswith("/var"):
      flat[key] = (1.0 + rng.random(value.shape)).astype(np.float32)
  return flat


def _port_inception(flat):
  model = InceptionV3()
  model.load_state_dict(bridge.state_dict_from_flat(flat))
  return model.eval()


def test_inception_v3_matches_jax():
  """Bridged weights, batch 2 at 75x75, the smallest input it takes."""
  flat = _inception_weights()
  x = np.random.default_rng(2).uniform(-1, 1, (2, 75, 75, 3)).astype(
      np.float32)
  want_pool, want_logits = jax.jit(
      lambda v, im: JInceptionV3().apply(v, im, train=False))(
          j_weights.unflatten_tree(flat), jnp.asarray(x))
  with torch.no_grad():
    pool, logits = _port_inception(flat)(torch.from_numpy(x))
  for got, want in ((pool, want_pool), (logits, want_logits)):
    want = np.asarray(want)
    _close(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_inception_weights_load_jax_npz(tmp_path):
  """``load_or_init`` reads the JAX package's layout: the port's tower has
  the JAX tower's arrays, by flattened name and shape (from the JAX init's
  shapes), and an ``.npz`` in that layout loads exactly."""
  shapes = jax.eval_shape(lambda rng: JInceptionV3().init(
      rng, jnp.ones((1, 75, 75, 3)), train=False), jax.random.PRNGKey(0))
  j_shapes = {k: tuple(v.shape) for k, v in j_weights.flatten_tree(
      jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                             dict(shapes))).items()}
  flat = _inception_weights()
  assert {k: v.shape for k, v in flat.items()} == j_shapes
  path = str(tmp_path / "inception.npz")
  np.savez(path, **flat)
  model = inception_weights.load_or_init(InceptionV3(), path)
  assert not model.training
  got = bridge.flat_from_state_dict(model.state_dict())
  assert set(got) == set(flat)
  for key, value in flat.items():
    np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_inception_weights_mismatch_rejected(tmp_path):
  path = str(tmp_path / "bad.npz")
  np.savez(path, **{"params/bogus/kernel": np.zeros((3, 3))})
  with pytest.raises(ValueError, match="mismatch"):
    inception_weights.load_or_init(InceptionV3(), path)
  flat = dict(_inception_weights())
  flat["params/predictions/bias"] = np.zeros((7,), np.float32)
  np.savez(path, **flat)
  with pytest.raises(ValueError, match="Shape mismatch"):
    inception_weights.load_or_init(InceptionV3(), path)


def test_make_inception_fn_matches_jax(tmp_path, monkeypatch):
  """32 px images through both feature functions (bilinear resize to 299,
  [-1, 1], InceptionV3, softmax) on the same ``.npz`` weights.  The JAX
  loader's template init (a 299 px compile, only to check names and
  shapes, which `test_inception_weights_load_jax_npz` checks) is skipped:
  it returns the ``.npz`` as it would after its checks."""
  path = str(tmp_path / "inception.npz")
  np.savez(path, **_inception_weights())
  monkeypatch.setattr(
      j_eval_metrics.inception_weights, "load_or_init",
      lambda model, ckpt: j_weights.unflatten_tree(dict(np.load(ckpt))))
  images = np.random.default_rng(3).random((2, 32, 32, 3), np.float32)
  want_pool, want_probs = jax.jit(j_eval_metrics.make_inception_fn(path))(
      jnp.asarray(images))
  got_pool, got_probs = eval_metrics.make_inception_fn(path)(
      torch.from_numpy(images))
  want_pool = np.asarray(want_pool)
  _close(got_pool, want_pool, rtol=0, atol=1e-4 * np.abs(want_pool).max())
  _close(got_probs, want_probs, rtol=1e-4, atol=1e-7)
  np.testing.assert_allclose(got_probs.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_streaming_statistics_match_jax():
  """Gaussian statistics, FID and IS of the same float32 pools, streamed
  in batches with a trimmed last batch."""
  rng = np.random.default_rng(4)
  a = rng.standard_normal((60, 16)).astype(np.float32)
  b = (1.5 * rng.standard_normal((60, 16)) + 0.3).astype(np.float32)
  logits = rng.standard_normal((60, 10)).astype(np.float32)
  probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)

  stats = {}
  for name, lib, wrap in (("port", fid, torch.from_numpy),
                          ("jax", j_fid, jnp.asarray)):
    pools = []
    for pool in (a, b):
      s = lib.StreamingGaussianStats(16)
      for chunk in np.split(pool, 4):
        s.update(wrap(chunk))
      s.update(wrap(pool[:8]), count=0)   # a trimmed batch adds nothing
      pools.append(s.compute())
    score = lib.StreamingInceptionScore(10, 3, 60)
    for chunk in np.split(probs, 6):
      score.update(wrap(chunk))
    stats[name] = dict(
        pools=pools, fid=lib.frechet_distance(*pools[0], *pools[1]),
        direct=lib.calculate_fid(a, b), score=score.compute())
  port, ref = stats["port"], stats["jax"]
  for (mu, sigma), (j_mu, j_sigma) in zip(port["pools"], ref["pools"]):
    np.testing.assert_allclose(mu, j_mu, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(sigma, j_sigma, rtol=1e-9, atol=1e-12)
  for key in ("fid", "direct", "score"):
    np.testing.assert_allclose(port[key], ref[key], rtol=1e-9)
  np.testing.assert_allclose(port["fid"], port["direct"], rtol=1e-6)


def _bridged_state(seed=5):
  """The JAX test-config state with EMA and batch statistics moved off
  their init values, and the same state in the port."""
  j_config = j_coco_xmc.get_test_config()
  j_config.dtype = "float32"
  config = coco_xmc.get_test_config()
  config.dtype = "float32"
  rng = np.random.default_rng(seed)
  n = config.batch_size
  batch = {
      "image": rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
      "embedding": rng.standard_normal((n, 17, 768), dtype=np.float32),
      "max_len": rng.integers(3, 18, (n, 1)).astype(np.float32),
      "sentence_embedding": rng.standard_normal((n, 768), dtype=np.float32),
      "z": rng.standard_normal((n, config.z_dim), dtype=np.float32),
  }
  generator, _, j_st = j_state(j_config, jax.random.PRNGKey(0), batch)
  j_st = jax.device_get(j_st)
  noise = lambda x: np.asarray(x) + 0.01 * rng.standard_normal(  # noqa: E731
      np.shape(x)).astype(np.float32)
  stats = jax.tree_util.tree_map(
      lambda x: np.abs(noise(x)) if np.all(np.asarray(x) == 1) else noise(x),
      j_st.generator_state["batch_stats"])
  j_st = j_st.replace(ema_params=jax.tree_util.tree_map(noise,
                                                        j_st.ema_params),
                      generator_state={"batch_stats": stats})
  state = create_train_state(config, "cpu", seed=0)
  bridge.load_jax_variables(state.generator, {
      "params": j_st.g_params, "batch_stats": stats})
  state.ema_params = bridge.tree_to_torch(j_st.ema_params)
  return j_config, config, generator, j_st, state, batch


def test_generate_batch_matches_jax():
  """Normal and EMA samples on bridged state with ``z`` in the batch, G in
  eval mode: running statistics used and left unchanged."""
  j_config, config, generator, j_st, state, batch = _bridged_state()
  want = jax.jit(functools.partial(
      j_sampling.generate_batch, generator=generator, config=j_config))(
          jax.random.PRNGKey(0), j_st, batch)
  before = {k: v.clone() for k, v in state.generator.state_dict().items()}
  state.generator.train()
  got = sampling.generate_batch(state, bridge.to_tensors(batch), config)
  assert state.generator.training   # the mode is restored
  for key, value in state.generator.state_dict().items():
    torch.testing.assert_close(value, before[key], rtol=0, atol=0)
  for key in ("generated_image", "ema_generated_image", "image"):
    assert got[key].dtype == torch.float32
    _close(got[key], want[key], rtol=1e-4, atol=1e-5)
  # The two weight sets give different images.
  assert float((got["generated_image"]
                - got["ema_generated_image"]).abs().max()) > 1e-3


def test_generate_sample_from_random_conditions():
  """Random sentence and word features, caption lengths and ``z`` drawn
  from the generator given: both weight sets give [0, 1] images, the same
  ones again from the same seed."""
  config = coco_xmc.get_test_config()
  state = create_train_state(config, "cpu", seed=0)
  out = [sampling.generate_sample(state, config, 3,
                                  torch.Generator().manual_seed(1))
         for _ in range(2)]
  assert set(out[0]) == {"generated_image", "ema_generated_image"}
  for key, images in out[0].items():
    assert tuple(images.shape) == (3, 32, 32, 3)
    assert 0.0 <= float(images.min()) and float(images.max()) <= 1.0
    torch.testing.assert_close(images, out[1][key], rtol=0, atol=0)


def test_evaluate_continuously_writes_scores(tmp_path):
  """Train one step on the CPU, then run the service end to end: one
  ``scores.csv`` row per checkpoint with finite FID and IS for the normal
  and EMA weights; a second run finds nothing new to score."""
  config = coco_xmc.get_test_config()
  config.num_train_steps = 1
  workdir = str(tmp_path / "exp")
  train_lib.train(config, workdir, "cpu")
  metric = evaluate.evaluate_continuously(config, workdir, "cpu", timeout=1)
  assert metric.last_images == 2 * config.eval_num
  scores = os.path.join(workdir, "checkpoints", "scores.csv")
  with open(scores) as f:
    rows = list(csv.DictReader(f))
  assert [row["step"] for row in rows] == ["1"]
  for key in ("eval/fid", "eval/ema_fid", "eval/inception_score",
              "eval/ema_inception_score"):
    assert np.isfinite(float(rows[0][key])), key
  evaluate.evaluate_continuously(config, workdir, "cpu", timeout=1)
  with open(scores) as f:
    assert len(list(csv.DictReader(f))) == 1

"""D and G of the flagship configuration at full width against the JAX
package, on the CPU: 128 px, ``df_dim = gf_dim = 96``, batch 2, float32,
on the port's initialization bridged into JAX.

* D in train mode on ``concat([real, fake])`` (4 images): the logit, the
  15 statistics of the five contrastive heads (the word heads at R = 256
  regions, L = 17 words, D = 768), the advanced ``u0``, and the gradients
  of ``sum(logit * c) + the five head losses`` with respect to every
  parameter, the images, the word embeddings and the sentence
  embeddings.  JAX runs its plain word-score path (``use_pallas=False``),
  the port its kernels' plain versions (``use_pallas=True`` on CPU
  tensors).
* G in train mode: the images and the updated ``batch_stats``.

Tolerances, float32 on both sides (XLA:CPU and PyTorch sum the convs in
other orders through six blocks at width 96):
* logit and images: 1e-4 relative, 1e-5 absolute;
* head statistics: 1e-4 absolute (sums of log-probabilities, order 1);
* ``u0`` and ``batch_stats``: 1e-4 relative, 1e-5 absolute;
* gradients of the parameters and the embeddings: 1e-3 relative plus
  1e-3 of the tensor's largest magnitude, and at least 1e-5 of the
  largest gradient of the whole tree (a gradient that is zero in exact
  arithmetic is float noise on both sides), as
  ``tests/test_torch_step.py`` holds them;
* the gradient of the images: a pixel's gradient runs through the
  ReLUs of the first blocks alone, and an activation within rounding of
  zero takes either side in the two frameworks (the measured deviation
  changes between runs of the same code, since both sum in threads):
  5e-3 of its L2 norm for the whole, and 2e-2 of its largest magnitude
  for each pixel (measured: 1.2e-3 of the norm, 1.0e-2 of the largest
  magnitude at worst; the parameters' gradients sum over the pixels and
  hold 6e-5 of their norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.models import get_architecture as j_arch
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.models import xmc_net
from xmcgan_image_generation_tpu_torch.utils import bridge

MUTABLE = ["batch_stats", "spectral_norm_stats"]
HEADS = ("real_word_loss", "fake_word_loss", "real_sentence_loss",
         "fake_sentence_loss", "image_contrastive_loss")
INPUTS = ("images", "embedding", "sentence_embedding")


def _configs():
  j_config, config = j_coco_xmc.get_config(), coco_xmc.get_config()
  j_config.dtype = config.dtype = "float32"
  j_config.use_pallas = False
  assert config.use_pallas and config.image_size == 128
  assert config.df_dim == config.gf_dim == 96
  return j_config, config


def _batch(config, n=2, seed=0):
  rng = np.random.default_rng(seed)
  s = config.image_size
  return {
      "image": rng.uniform(0, 1, (n, s, s, 3)).astype(np.float32),
      "embedding": rng.standard_normal((n, 17, 768)).astype(np.float32),
      "sentence_embedding": rng.standard_normal((n, 768)).astype(np.float32),
      "max_len": np.array([[17], [6]], np.float32)[:n],
      "z": rng.standard_normal((n, config.z_dim)).astype(np.float32),
  }


def _variables(module):
  """The module's variables as JAX's trees, copied: ``u0`` and the
  running statistics would otherwise share memory with the buffers that
  the port's train-mode forward updates in place."""
  return bridge.jax_from_state_dict(
      {k: v.clone() for k, v in module.state_dict().items()})


def close(got, want, rtol=1e-4, atol=1e-5, msg=""):
  if isinstance(got, torch.Tensor):
    got = got.detach().numpy()
  np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                             atol=atol, err_msg=msg)


def close_grads(got, want):
  assert set(got) == set(want)
  top = max(float(np.abs(v).max()) for v in want.values())
  for name in want:
    w = np.asarray(want[name], np.float32)
    tol = max(1e-3 * float(np.abs(w).max()), 1e-5 * top)
    close(got[name], w, rtol=1e-3, atol=tol, msg=name)


@pytest.fixture(scope="module")
def threads():
  """Four threads for the full-width convolutions, then the count that
  the other test modules set back."""
  old = torch.get_num_threads()
  torch.set_num_threads(4)
  yield
  torch.set_num_threads(old)


@pytest.fixture(scope="module")
def disc_run(threads):
  j_config, config = _configs()
  batch = _batch(config)
  rng = np.random.default_rng(1)
  fake = rng.uniform(0, 1, batch["image"].shape).astype(np.float32)
  images = np.concatenate([batch["image"], fake])
  c = rng.standard_normal((4, 1)).astype(np.float32)

  d = xmc_net.Discriminator(config, generator=torch.Generator().manual_seed(0))
  assert sum(p.numel() for p in d.parameters()) == 87_911_713
  variables = _variables(d)
  d.train()
  params = dict(d.named_parameters())
  x = {"images": torch.from_numpy(images).requires_grad_(),
       "embedding": torch.from_numpy(batch["embedding"]).requires_grad_(),
       "sentence_embedding": torch.from_numpy(
           batch["sentence_embedding"]).requires_grad_()}
  cond = {"embedding": x["embedding"],
          "sentence_embedding": x["sentence_embedding"],
          "max_len": torch.from_numpy(batch["max_len"])}
  logit, stats = d(x["images"], cond)
  loss = (logit * torch.from_numpy(c)).sum() + sum(stats[h] for h in HEADS)
  grads = torch.autograd.grad(loss, list(params.values())
                              + [x[k] for k in INPUTS])
  port = dict(
      logit=logit.detach(),
      stats={k: float(v.detach()) for k, v in stats.items()},
      u0=bridge.flatten(bridge.jax_from_state_dict(
          d.state_dict())["spectral_norm_stats"]),
      param_grads=bridge.flatten(bridge.tensors_to_jax(
          dict(zip(params, grads[:len(params)])))),
      input_grads={k: g.numpy() for k, g in zip(INPUTS,
                                                grads[len(params):])})
  del d, params, grads

  _, disc = j_arch(j_config, jnp.float32)
  rest = {k: v for k, v in variables.items() if k != "params"}

  def f(p, images, embedding, sentence_embedding):
    cond = dict(batch, embedding=embedding,
                sentence_embedding=sentence_embedding)
    (logit, stats), new = disc(train=True).apply(
        {"params": p, **rest}, (images, cond), mutable=MUTABLE)
    loss = jnp.sum(logit * c) + sum(stats[h] for h in HEADS)
    return loss, (logit, stats, new)

  (_, (logit, stats, new)), grads = jax.jit(jax.value_and_grad(
      f, argnums=(0, 1, 2, 3), has_aux=True))(
          variables["params"], images, batch["embedding"],
          batch["sentence_embedding"])
  want = jax.device_get(dict(
      logit=logit, stats=stats, u0=new["spectral_norm_stats"],
      param_grads=grads[0], input_grads=dict(zip(INPUTS, grads[1:]))))
  return port, want


def test_discriminator_logit(disc_run):
  port, want = disc_run
  assert port["logit"].shape == (4, 1)
  close(port["logit"], want["logit"])


def test_discriminator_five_heads(disc_run):
  port, want = disc_run
  assert set(port["stats"]) == set(want["stats"]) == set(xmc_net.STAT_NAMES)
  for name in xmc_net.STAT_NAMES:
    close(port["stats"][name], want["stats"][name], rtol=0, atol=1e-4,
          msg=name)


def test_discriminator_u0(disc_run):
  port, want = disc_run
  want_u0 = bridge.flatten(want["u0"])
  assert set(port["u0"]) == set(want_u0)
  for name, value in port["u0"].items():
    close(value, want_u0[name], msg=name)


def test_discriminator_parameter_gradients(disc_run):
  port, want = disc_run
  close_grads(port["param_grads"], bridge.flatten(want["param_grads"]))


@pytest.mark.parametrize("name", INPUTS[1:])
def test_discriminator_embedding_gradients(disc_run, name):
  port, want = disc_run
  close_grads({name: port["input_grads"][name]},
              {name: want["input_grads"][name]})


def test_discriminator_image_gradient(disc_run):
  """Held by its norm: see the module's docstring."""
  port, want = disc_run
  got, w = port["input_grads"]["images"], want["input_grads"]["images"]
  assert np.linalg.norm(got - w) <= 5e-3 * np.linalg.norm(w)
  close(got, w, rtol=0, atol=2e-2 * float(np.abs(w).max()))


@pytest.fixture(scope="module")
def gen_run(threads):
  j_config, config = _configs()
  batch = _batch(config, seed=2)
  g = xmc_net.Generator(config, generator=torch.Generator().manual_seed(0))
  assert sum(p.numel() for p in g.parameters()) == 78_507_779
  variables = _variables(g)
  g.train()
  x = {k: torch.from_numpy(v) for k, v in batch.items()}
  with torch.no_grad():
    images = g(x, x["z"]).numpy()
  stats = bridge.flatten(bridge.jax_from_state_dict(
      g.state_dict())["batch_stats"])
  del g
  gen, _ = j_arch(j_config, jnp.float32)
  want, new = jax.jit(lambda v, b: gen(train=True).apply(
      v, (b, b["z"]), mutable=MUTABLE))(variables, batch)
  return (images, stats), jax.device_get(
      (want, bridge.flatten(new["batch_stats"])))


def test_generator_train_mode_images(gen_run):
  (images, _), (want, _) = gen_run
  assert images.shape == (2, 128, 128, 3)
  assert np.mean((images > 0) & (images < 1)) > 0.5   # not saturated
  close(images, want)


def test_generator_train_mode_batch_stats(gen_run):
  (_, stats), (_, want) = gen_run
  assert set(stats) == set(want)
  for name, value in stats.items():
    close(value, want[name], msg=name)

"""Full-width sizes of the port's models against the JAX package's.

The port's G and D are built on the ``meta`` device (shapes only, no
draws, no memory), so full width costs well under a second.  At 128 px
they are held to the JAX package's goldens (`tests/test_models.py`, its
full-config counts); at 256 px to the JAX package's own counts, from
``jax.eval_shape`` of its initialization (traced, never computed).
Counted: G's parameters and batch statistics (``mean`` and ``var``), D's
parameters and spectral-norm ``u0``.  Exact integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xmcgan_image_generation_tpu.configs import coco_xmc_256 as j_coco_256
from xmcgan_image_generation_tpu.models import get_architecture as j_arch
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.configs import coco_xmc_256
from xmcgan_image_generation_tpu_torch.models import xmc_net

# tests/test_models.py::TestParamCounts::test_full_config_counts
GOLDEN_128 = dict(g_params=78_507_779, g_batch_stats=14_976,
                  d_params=87_911_713, d_u0=14_305)


def _port_counts(config):
  g = xmc_net.Generator(config, device="meta")
  d = xmc_net.Discriminator(config, device="meta")

  def buffers(module, leaf):
    return sum(b.numel() for n, b in module.named_buffers()
               if n.rsplit(".", 1)[-1] in leaf)

  return dict(g_params=sum(p.numel() for p in g.parameters()),
              g_batch_stats=buffers(g, ("mean", "var")),
              d_params=sum(p.numel() for p in d.parameters()),
              d_u0=buffers(d, ("u0",)))


def _jax_counts(j_config):
  gen, disc = j_arch(j_config, jnp.float32)
  n, s, length, dim = 2, j_config.image_size, 17, 768
  batch = {
      "embedding": jax.ShapeDtypeStruct((n, length, dim), jnp.float32),
      "sentence_embedding": jax.ShapeDtypeStruct((n, dim), jnp.float32),
      "max_len": jax.ShapeDtypeStruct((n, 1), jnp.float32),
  }
  z = jax.ShapeDtypeStruct((n, j_config.z_dim), jnp.float32)
  images = jax.ShapeDtypeStruct((2 * n, s, s, 3), jnp.float32)
  rng = jax.random.PRNGKey(0)
  g_vars = jax.eval_shape(
      lambda b, z: gen(train=False).init(rng, (b, z)), batch, z)
  d_vars = jax.eval_shape(
      lambda x, b: disc(train=False).init(rng, (x, b)), images, batch)

  def count(tree):
    return sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(tree))

  return dict(g_params=count(g_vars["params"]),
              g_batch_stats=count(g_vars["batch_stats"]),
              d_params=count(d_vars["params"]),
              d_u0=count(d_vars["spectral_norm_stats"]))


def test_flagship_counts_match_the_jax_goldens():
  assert _port_counts(coco_xmc.get_config()) == GOLDEN_128


@pytest.fixture(scope="module")
def jax_256():
  return _jax_counts(j_coco_256.get_config())


@pytest.mark.parametrize("what", sorted(GOLDEN_128))
def test_256px_counts_match_jax(jax_256, what):
  assert _port_counts(coco_xmc_256.get_config())[what] == jax_256[what]


def test_256px_model_is_larger_than_the_flagship(jax_256):
  # The extra up- and down-sampling blocks of the 256 px scale.
  for what in ("g_params", "d_params"):
    assert jax_256[what] > GOLDEN_128[what]

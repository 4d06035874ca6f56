"""The port's plain ops against the JAX package's, on the CPU.

Same numpy-seeded inputs through both; images are NHWC in JAX and NCHW in
the port's conv-stack ops, kernels HWIO and OIHW (`utils.bridge`).
Tolerance, unless a test says otherwise: float32 on both sides with other
summation orders, 1e-5 relative / 1e-6 absolute.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu.ops import attention as j_attention
from xmcgan_image_generation_tpu.ops import contrastive as j_contrastive
from xmcgan_image_generation_tpu.ops import images as j_images
from xmcgan_image_generation_tpu.ops import losses as j_losses
from xmcgan_image_generation_tpu.ops import pooling as j_pooling
from xmcgan_image_generation_tpu.ops import scale_fuse as j_scale_fuse
from xmcgan_image_generation_tpu.ops import spectral_norm as j_sn
from xmcgan_image_generation_tpu_torch.ops import attention
from xmcgan_image_generation_tpu_torch.ops import contrastive
from xmcgan_image_generation_tpu_torch.ops import images
from xmcgan_image_generation_tpu_torch.ops import losses
from xmcgan_image_generation_tpu_torch.ops import normalization
from xmcgan_image_generation_tpu_torch.ops import pooling
from xmcgan_image_generation_tpu_torch.ops import scale_fuse
from xmcgan_image_generation_tpu_torch.ops import spectral_norm
from xmcgan_image_generation_tpu_torch.utils import bridge

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
  if isinstance(got, torch.Tensor):
    got = got.detach().float().numpy()
  np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                             atol=atol)


def rand(shape, seed=0):
  return np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)


def t(x):
  return torch.from_numpy(np.array(x))


def nhwc(x):
  return bridge.nchw_to_nhwc(x)


class TestLosses:

  def test_hinge(self):
    real, fake = rand((8, 1), 0), rand((8, 1), 1)
    d, g = losses.hinge(t(real), t(fake))
    jd, jg = j_losses.hinge(real, fake)
    close(d, jd)
    close(g, jg)

  def test_softmax_cross_entropy(self):
    labels = np.eye(6, dtype=np.float32)
    logits = rand((6, 6), 2) * 10
    close(losses.softmax_cross_entropy(labels=t(labels), logits=t(logits)),
          j_losses.softmax_cross_entropy(labels=labels, logits=logits))

  def test_image_to_float(self):
    x = np.random.default_rng(3).integers(0, 256, (2, 4, 4, 3), np.uint8)
    close(images.image_to_float(t(x)), j_images.image_to_float(x), 0, 0)


class TestPooling:

  def test_upsample(self):
    x = rand((2, 4, 4, 3))
    close(nhwc(pooling.upsample(bridge.nhwc_to_nchw(t(x)))),
          j_pooling.upsample(x), 0, 0)

  def test_dsample(self):
    x = rand((2, 8, 8, 3))
    close(nhwc(pooling.dsample(bridge.nhwc_to_nchw(t(x)))),
          j_pooling.dsample(x))

  def test_padded_avg_pool_is_not_ported(self):
    with pytest.raises(NotImplementedError):
      pooling.tf_avg_pool(torch.zeros(1, 1, 5, 5), (2, 2), (2, 2), "SAME")


class TestScaleFuse:
  """Both mappings of scale_fuse against the JAX ops in float32."""

  @pytest.mark.parametrize("op", ["upsample_conv_dilated", "conv_pool"])
  def test_matches_jax(self, op):
    x = rand((2, 8, 8, 5), 4)
    w = rand((3, 3, 5, 7), 5)
    want = getattr(j_scale_fuse, op)(x, w)
    w_oihw = t(w.transpose(3, 2, 0, 1))
    got = getattr(scale_fuse, op)(bridge.nhwc_to_nchw(t(x)), w_oihw)
    close(nhwc(got), want, rtol=1e-5, atol=1e-5)


def _jax_layer(layer, x, train):
  variables = layer.init(jax.random.PRNGKey(0), x)
  y, new = layer.apply(variables, x, mutable=["spectral_norm_stats"])
  return variables, y, new


class TestSpectralNorm:
  """Output and the new ``u0`` of one power-iteration step."""

  @pytest.mark.parametrize("train", [True, False])
  def test_conv(self, train):
    x = rand((2, 6, 6, 4), 6)
    layer = j_sn.SpectralConv(features=5, train=train,
                              kernel_init=jax.nn.initializers.glorot_normal())
    variables, want, new = _jax_layer(layer, x, train)
    conv = spectral_norm.Conv(4, 5, (3, 3), spectral=True)
    bridge.load_jax_variables(conv, jax.device_get(variables))
    conv.train(train)
    got = conv(bridge.nhwc_to_nchw(t(x)))
    close(nhwc(got), want, rtol=1e-5, atol=1e-5)
    close(conv.u0, new["spectral_norm_stats"]["u0"])
    if not train:
      close(conv.u0, variables["spectral_norm_stats"]["u0"], 0, 0)

  def test_dense_and_sigma_gradient(self):
    x = rand((3, 6), 7)
    layer = j_sn.SpectralDense(features=4, train=True)
    variables, want, new = _jax_layer(layer, x, True)
    dense = spectral_norm.Dense(6, 4, spectral=True)
    bridge.load_jax_variables(dense, jax.device_get(variables))
    got = dense(t(x))
    close(got, want)
    close(dense.u0, new["spectral_norm_stats"]["u0"])

    # sigma carries gradient, u and v do not.
    def j_loss(params):
      y, _ = layer.apply({**variables, "params": params}, x,
                         mutable=["spectral_norm_stats"])
      return jnp.sum(y ** 2)

    want_grad = jax.grad(j_loss)(variables["params"])["kernel"]
    dense.u0.copy_(t(variables["spectral_norm_stats"]["u0"]))
    (dense(t(x)) ** 2).sum().backward()
    close(dense.kernel.grad.t(), want_grad, rtol=1e-4, atol=1e-6)


class TestBatchNorm:

  def _both(self, train):
    x = rand((4, 5, 5, 3), 8) * 2 + 1
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                       epsilon=1e-5, use_bias=False, use_scale=False)
    variables = bn.init(jax.random.PRNGKey(0), x)
    variables = {"batch_stats": {"mean": np.full(3, 0.5, np.float32),
                                 "var": np.full(3, 2.0, np.float32)}}
    want, new = bn.apply(variables, x, mutable=["batch_stats"])
    port = normalization.BatchNorm(3)
    bridge.load_jax_variables(port, variables)
    port.train(train)
    return x, want, new, port

  @pytest.mark.parametrize("train", [True, False])
  def test_output_and_running_stats(self, train):
    x, want, new, port = self._both(train)
    got = port(bridge.nhwc_to_nchw(t(x)))
    close(nhwc(got), want, rtol=1e-5, atol=1e-5)
    close(port.mean, new["batch_stats"]["mean"])
    close(port.var, new["batch_stats"]["var"])

  def test_frozen_stats_mode(self):
    x, want, _, port = self._both(True)
    with normalization.frozen_batch_stats(port):
      got = port(bridge.nhwc_to_nchw(t(x)))
    close(nhwc(got), want, rtol=1e-5, atol=1e-5)
    close(port.mean, np.full(3, 0.5), 0, 0)
    close(port.var, np.full(3, 2.0), 0, 0)
    assert port.update_stats


class TestAttention:

  def _features(self, seed=9, batch=3, regions=16, words=5, dim=8):
    rng = np.random.default_rng(seed)
    region = rng.standard_normal((batch, regions, dim)).astype(np.float32)
    word = rng.standard_normal((batch, words, dim)).astype(np.float32)
    max_len = rng.integers(2, words + 1, (batch, 1)).astype(np.float32)
    return region, word, max_len

  def test_padding_mask(self):
    _, word, max_len = self._features()
    close(attention.padding_mask(t(max_len), word.shape[1]),
          j_attention.padding_mask(max_len, word.shape[1]), 0, 0)

  def test_attention_for_g(self):
    region, word, max_len = self._features()
    mask = j_attention.padding_mask(max_len, word.shape[1])
    want_ctx, want_attn = j_attention.attention_for_g(region, word, 15.0,
                                                      mask)
    got_ctx, got_attn = attention.attention_for_g(t(region), t(word), 15.0,
                                                  t(mask))
    close(got_ctx, want_ctx)
    close(got_attn, want_attn)

  def test_word_loss_einsum(self):
    region, word, max_len = self._features(seed=10)
    want = j_attention.word_loss(region, word, max_len)
    got = attention.word_loss(t(region), t(word), t(max_len))
    close(torch.stack(got), np.array(want), rtol=1e-5, atol=1e-5)


class TestContrastive:

  def test_l2_normalize(self):
    x = rand((4, 6), 11)
    close(contrastive.l2_normalize(t(x)), j_contrastive.l2_normalize(x, -1))

  def test_nt_xent_einsum(self):
    a, b = rand((6, 10), 12), rand((6, 10), 13)
    want = j_contrastive.nt_xent(a, b)
    got = contrastive.nt_xent(t(a), t(b))
    close(torch.stack(got), np.array(want))

  def test_nt_xent_fused_path_equals_einsum_path(self):
    """use_pallas selects the fused op; off ties, the numbers agree."""
    a, b = rand((6, 10), 14), rand((6, 10), 15)
    close(torch.stack(contrastive.nt_xent(t(a), t(b), use_pallas=True)),
          torch.stack(contrastive.nt_xent(t(a), t(b))).numpy())

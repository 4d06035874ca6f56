"""XMC-GAN's generator and discriminator and the ResNet-50 v1 tower, as
functions of a `layers.Scope`.

The layouts are those of the published model (arXiv 2101.04702;
google-research/xmcgan_image_generation ``xmcgan/nets/xmc_net.py``) in
the form the configurations state: the generator modulates its spatial
blocks with the word-region context at the context's own resolution
(``fused_spatial_cond``, upsampled per block), and with
``scale_fused_convs`` each up-convolution and pooled convolution is one
convolution (`layers.conv`).  Images are NHWC in ``[0, 1]``; the
networks run NCHW.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import layers
from benchmark.reference.layers import Scope

Tensor = torch.Tensor
BERT_DIM = 768
TEXT_LEN = 17  # words a caption, padded
RESNET_SIZE = 224

# Channel multipliers and downsampling by image size, as published; 32 and
# 64 px serve the tests.
GEN_CHANNELS = {32: (16, 8, 4), 64: (16, 8, 4, 2), 128: (16, 8, 4, 2, 1),
                256: (16, 8, 8, 4, 2, 1)}
DISC_CHANNELS = {32: (2, 4, 8), 64: (2, 4, 8, 16), 128: (2, 4, 8, 16, 16),
                 256: (2, 4, 8, 8, 16, 16)}
DISC_DOWN = {32: (False, True, False), 64: (True, True, True, False),
             128: (True, True, True, True, False),
             256: (True, True, True, True, True, False)}
HEAD_STATS = ("real_word", "fake_word", "real_sentence", "fake_sentence",
              "image")


def check_config(cfg) -> None:
  """Raises on a configuration the reference does not cover."""
  if (cfg["g_spectral_norm"] or not cfg["fused_spatial_cond"]
      or cfg["batch_norm_group_size"] > 0
      or cfg["contrastive_group_size"] > 0
      or cfg["image_size"] not in GEN_CHANNELS
      or cfg["architecture"] != "xmc_net" or cfg["model_name"] != "xmc"
      or (cfg["scale_fused_convs"] and cfg["upconv_method"] != "dilated")):
    raise NotImplementedError("the reference covers the fused-layout XMC-GAN "
                              "at 32 to 256 px with whole-batch pools")


def _modulated_norm(s: Scope, x: Tensor, gamma: Tensor, beta: Tensor,
                    training: bool) -> Tensor:
  return layers.batch_norm(s("BatchNorm_0"), x, training) * (gamma + 1.0) + beta


def _cond_bn(s: Scope, x: Tensor, cond: Tensor, training: bool) -> Tensor:
  """BatchNorm modulated by dense maps of the global conditioning."""
  c, n = x.shape[1], cond.shape[1]
  gamma = layers.dense(s("Dense_0"), cond, n, c)[:, :, None, None]
  beta = layers.dense(s("Dense_1"), cond, n, c)[:, :, None, None]
  return _modulated_norm(s, x, gamma, beta, training)


def _spatial_mod(s: Scope, x: Tensor, ctx: Tensor, cond: Tensor,
                 factor: int, training: bool) -> Tensor:
  """BatchNorm modulated per pixel: a 1x1 conv of the region context,
  upsampled by ``factor``, plus a dense map of the global conditioning."""
  c = x.shape[1]

  def modulation(name):
    local = layers.conv(s(f"{name}_ctx"), ctx, ctx.shape[1], c, 1,
                        bias=False)
    glob = layers.dense(s(f"{name}_global"), cond, cond.shape[1], c)
    return layers.upsample(local, factor) + glob[:, :, None, None]

  return _modulated_norm(s, x, modulation("gamma"), modulation("beta"),
                         training)


def _up_block(s: Scope, norm, x: Tensor, out_f: int, fuse: bool) -> Tensor:
  """norm-relu-up-conv3, norm-relu-conv3, plus an upsampled 1x1 shortcut;
  ``norm(scope, x, index)`` is the block's conditional norm."""
  in_f = x.shape[1]
  h = F.relu(norm(x, 0))
  h = layers.conv(s("Conv_0"), h if fuse else layers.upsample(h), in_f,
                  out_f, 3, scale_op="up" if fuse else None)
  h = F.relu(norm(h, 1))
  h = layers.conv(s("Conv_1"), h, out_f, out_f, 3)
  if fuse:
    shortcut = layers.upsample(layers.conv(s("Conv_2"), x, in_f, out_f, 1))
  else:
    shortcut = layers.conv(s("Conv_2"), layers.upsample(x), in_f, out_f, 1)
  return h + shortcut


def generator(s: Scope, cfg, cond: Dict[str, Tensor], z: Tensor,
              training: bool) -> Tensor:
  """Images ``[B, S, S, 3]`` in ``[0, 1]`` from the sentence embedding
  ``[B, 768]``, the word embeddings ``[B, L, 768]``, the caption lengths
  ``[B, 1]`` and the latent ``[B, z_dim]``."""
  gf, z_dim, fuse = cfg["gf_dim"], cfg["z_dim"], cfg["scale_fused_convs"]
  channels = GEN_CHANNELS[cfg["image_size"]]
  word = cond["embedding"].float()
  batch, total_len, _ = word.shape
  global_cond = torch.cat([layers.dense(
      s("Dense_0"), cond["sentence_embedding"].float(), BERT_DIM, z_dim),
      z.float()], dim=-1)
  x = layers.dense(s("Dense_1"), z.float(), z_dim, gf * 16 * 16)
  x = x.reshape(batch, 4, 4, gf * 16).permute(0, 3, 1, 2)
  for i in range(2):
    b = s(f"GenBlock_{i}")

    def gen_block(x, gc, b=b, out_f=gf * channels[i]):
      norm = lambda h, k: _cond_bn(b(f"ConditionalBatchNorm_{k}"), h, gc,  # noqa: E731
                                   training)
      return _up_block(b, norm, x, out_f, fuse)

    x = s.block(gen_block, x, global_cond)

  region = layers.conv(s("Conv_0"), x, x.shape[1], BERT_DIM, 1)
  side = region.shape[2]
  region = region.permute(0, 2, 3, 1).reshape(batch, side * side, BERT_DIM)
  mask = layers.padding_mask(cond["max_len"], total_len)
  ctx = layers.attention_for_g(s, region, word, mask, cfg["gamma_for_g"])
  ctx = ctx.reshape(batch, side, side, BERT_DIM).permute(0, 3, 1, 2)

  factor = 1
  for i in range(2, len(channels)):
    b = s(f"GenSpatialBlockFused_{i - 2}")

    def spatial_block(x, ctx, gc, b=b, out_f=gf * channels[i], f=factor):
      norm = lambda h, k: _spatial_mod(  # noqa: E731
          b(f"FusedSpatialModulation_{k}"), h, ctx, gc, f * 2 ** k, training)
      return _up_block(b, norm, x, out_f, fuse)

    x = s.block(spatial_block, x, ctx, global_cond)
    factor *= 2
  x = _spatial_mod(s("FusedSpatialModulation_0"), x, ctx, global_cond,
                   factor, training)
  x = torch.tanh(layers.conv(s("Conv_1"), F.relu(x), x.shape[1], 3, 3))
  return ((x + 1.0) / 2.0).permute(0, 2, 3, 1)


def _disc_block(s: Scope, x: Tensor, out_f: int, down: bool, sn: bool,
                fuse: bool, optimized: bool) -> Tensor:
  """A residual D block (pre-activation; the first, ``optimized``, conv
  first); with ``down`` 2x2 average pooling on both paths."""
  prefix = "SpectralConv" if sn else "Conv"
  in_f = x.shape[1]

  def c(i, h, cin, k, scale_op=None):
    return layers.conv(s(f"{prefix}_{i}"), h, cin, out_f, k,
                       spectral_norm=sn, scale_op=scale_op)

  pool = "pool" if fuse and down else None
  if optimized:
    h = c(1, F.relu(c(0, x, in_f, 3)), out_f, 3, pool)
    if not pool:
      h = layers.dsample(h)
    return h + c(2, layers.dsample(x), in_f, 1)
  h = c(1, F.relu(c(0, F.relu(x), in_f, 3)), out_f, 3, pool)
  project = down or in_f != out_f
  if pool:
    shortcut = layers.dsample(x)
    if project:
      shortcut = c(2, shortcut, in_f, 1)
    return h + shortcut
  shortcut = c(2, x, in_f, 1) if project else x
  if down:
    h, shortcut = layers.dsample(h), layers.dsample(shortcut)
  return h + shortcut


def discriminator(s: Scope, cfg, images: Tensor, cond: Dict[str, Tensor],
                  critic_only: bool = False
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
  """``images`` is ``concat([real, fake])``.  Returns the logits ``[2B,
  1]`` and the contrastive losses of `HEAD_STATS`; with ``critic_only``
  the heads the critic update does not use are left out."""
  df, sn, fuse = cfg["df_dim"], cfg["d_spectral_norm"], cfg["scale_fused_convs"]
  size = cfg["image_size"]
  x = images.float().permute(0, 3, 1, 2)
  x = s.block(lambda x: _disc_block(s("DiscOptimizedBlock_0"), x, df, True,
                                    sn, fuse, True), x)
  x_cond = None
  for i, (ratio, down) in enumerate(zip(DISC_CHANNELS[size], DISC_DOWN[size])):
    x = s.block(lambda x, i=i, ratio=ratio, down=down: _disc_block(
        s(f"DiscBlock_{i}"), x, df * ratio, down, sn, fuse, False), x)
    if x.shape[2] == cfg["cond_size"]:
      x_cond = x
  pool = F.relu(x).sum(dim=(2, 3))
  dense = "SpectralDense" if sn else "Dense"
  feat = pool.shape[1]
  logit = layers.dense(s(f"{dense}_0"), pool, feat, 1, spectral_norm=sn)
  sent = layers.dense(s(f"{dense}_1"), cond["sentence_embedding"].float(),
                      BERT_DIM, feat, spectral_norm=sn)
  logit = logit + (pool * sent.repeat(2, 1)).sum(dim=1, keepdim=True)
  real_pool, fake_pool = pool.chunk(2)
  out = {}
  if cfg["sentence_contrastive"]:
    out["real_sentence"] = layers.nt_xent(s, real_pool, sent)
    if not critic_only:
      out["fake_sentence"] = layers.nt_xent(s, fake_pool, sent)
  if cfg["word_contrastive"]:
    conv = "SpectralConv" if sn else "Conv"
    region = layers.conv(s(f"{conv}_0"), x_cond, x_cond.shape[1], BERT_DIM,
                         1, spectral_norm=sn)
    region = region.permute(0, 2, 3, 1).reshape(region.shape[0], -1,
                                                 BERT_DIM)
    real_region, fake_region = region.chunk(2)
    word, max_len = cond["embedding"].float(), cond["max_len"]
    out["real_word"] = layers.word_loss(s, real_region, word, max_len)
    if not critic_only:
      out["fake_word"] = layers.word_loss(s, fake_region, word, max_len)
  if cfg["image_contrastive"] and not critic_only:
    out["image"] = layers.nt_xent(s, fake_pool, real_pool)
  zero = torch.zeros((), device=logit.device)
  return logit, {name: out.get(name, zero) for name in HEAD_STATS}


def _max_pool_same(x: Tensor) -> Tensor:
  (pt, pb), (pl, pr) = (layers.same_pads(x.shape[2], 3, 2),
                        layers.same_pads(x.shape[3], 3, 2))
  return F.max_pool2d(F.pad(x, (pl, pr, pt, pb), value=float("-inf")), 3, 2)


def _bottleneck(s: Scope, x: Tensor, filters: int, stride: int,
                training: bool) -> Tensor:
  in_f = x.shape[1]

  def conv_bn(name, bn, h, cin, cout, k, st=1):
    h = layers.conv(s(name), h, cin, cout, k, stride=st, bias=False,
                    init="lecun")
    return layers.batch_norm(s(bn), h, training, affine=True)

  y = F.relu(conv_bn("conv1", "bn1", x, in_f, filters, 1))
  y = F.relu(conv_bn("conv2", "bn2", y, filters, filters, 3, stride))
  y = conv_bn("conv3", "bn3", y, filters, 4 * filters, 1)
  if in_f != 4 * filters or stride != 1:
    x = conv_bn("proj_conv", "proj_bn", x, in_f, 4 * filters, 1, stride)
  return F.relu(x + y)


def resnet50(s: Scope, images: Tensor, training: bool = False) -> Tensor:
  """The frozen tower's logits ``[B, 1000]`` of NHWC images, resized to
  224 x 224 bilinearly (half-pixel centres, antialiased where a side
  shrinks); BatchNorm takes its running averages (its batch statistics,
  recorded, with ``training``)."""
  if images.shape[1:3] != (RESNET_SIZE, RESNET_SIZE):
    images = F.interpolate(
        images.float().permute(0, 3, 1, 2), size=(RESNET_SIZE, RESNET_SIZE),
        mode="bilinear", align_corners=False,
        antialias=max(images.shape[1:3]) > RESNET_SIZE)
  else:
    images = images.float().permute(0, 3, 1, 2)
  x = layers.conv(s("init_conv"), images, 3, 64, 7, stride=2, bias=False,
                  init="lecun")
  x = _max_pool_same(layers.batch_norm(s("init_bn"), x, training,
                                      affine=True))
  in_f = 64
  for i, blocks in enumerate((3, 4, 6, 3)):

    def stage(x, i=i, blocks=blocks):
      for j in range(blocks):
        x = _bottleneck(s(f"stage{i + 1}_block{j + 1}"), x, 64 * 2 ** i,
                        2 if i > 0 and j == 0 else 1, training)
      return x

    x = s.block(stage, x)
    in_f = 256 * 2 ** i
  return layers.dense(s("head"), x.mean(dim=(2, 3)), in_f, 1000,
                      init="lecun")

"""XMC-Net: text-conditional generator and projection discriminator with
in-graph contrastive heads (the JAX package's ``models/xmc_net.py``).

The public calls take and return NHWC images; the conv stacks run NCHW.
Parameters are float32 and compute runs in the configured dtype.  G has
the JAX package's two layouts, chosen by its rule ``fused_spatial_cond
and not g_spectral_norm``: the fused one (the default: the spatial
modulation at the 16 x 16 context's resolution, `GenSpatialBlockFused`)
and the reference one (the concatenated, per-block upsampled
conditioning map, `GenSpatialBlock` and `LocalConditionalBatchNorm`),
which every G with ``g_spectral_norm`` takes; then every G conv and
dense is spectrally normalized and G holds ``u0`` buffers.  BatchNorm
statistics and contrastive pools are over the global batch (with a
process group, every process's rows: `parallel`), or over contiguous
groups of it with ``batch_norm_group_size`` and ``contrastive_group_size``
> 0.

``config.remat`` recomputes a block's forward in the backward instead of
keeping its activations (`torch.utils.checkpoint`, non-reentrant), for
the blocks whose largest side is at least ``remat_min_resolution`` (0:
all); ``remat_policy`` "full" saves nothing, "conv" saves the outputs of
convolutions and matmuls (`_matmul_saveable`, through a pair of dispatch
modes that serve any number of recomputes).  Parameter and buffer
names are the same with remat on or off.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from xmcgan_image_generation_tpu_torch.models import blocks
from xmcgan_image_generation_tpu_torch.ops import attention as attn_ops
from xmcgan_image_generation_tpu_torch.ops import contrastive as contrastive_ops
from xmcgan_image_generation_tpu_torch.ops.normalization import (
    FusedSpatialModulation,
    LocalConditionalBatchNorm,
    frozen_batch_stats,
)
from xmcgan_image_generation_tpu_torch.ops.pooling import upsample
from xmcgan_image_generation_tpu_torch.ops.spectral_norm import (
    Conv,
    Dense,
    precomputed_kernels,
)

Tensor = torch.Tensor
BERT_DIM = 768

_GEN_CHANNELS = {
    32: [16, 8, 4],
    64: [16, 8, 4, 2],
    128: [16, 8, 4, 2, 1],
    256: [16, 8, 8, 4, 2, 1],
}
_DISC_CHANNELS = {
    32: [2, 4, 8],
    64: [2, 4, 8, 16],
    128: [2, 4, 8, 16, 16],
    256: [2, 4, 8, 8, 16, 16],
}
_DISC_DOWNSAMPLE = {
    32: [False, True, False],
    64: [True, True, True, False],
    128: [True, True, True, True, False],
    256: [True, True, True, True, True, False],
}

STAT_NAMES = tuple(
    [f"{side}_{head}_{metric}" for side in ("real", "fake")
     for head in ("word", "sentence")
     for metric in ("loss", "acc", "entropy")]
    + [f"image_contrastive_{metric}"
       for metric in ("loss", "acc", "entropy")])


def compute_dtype(config) -> torch.dtype:
  return torch.bfloat16 if config.dtype == "bfloat16" else torch.float32


def _check_supported(config) -> None:
  """Raises on configuration branches the port does not have yet."""
  if config.get("scale_fused_convs", False) and config.get(
      "upconv_method", "phase") != "dilated":
    raise NotImplementedError("only upconv_method='dilated' is ported")


def _matmul_saveable(op) -> bool:
  """Remat policy "conv": save the outputs of convolutions and matmuls,
  recompute the elementwise work between them (BatchNorm, ReLU, the
  conditional modulation), as the JAX package's ``_matmul_saveable``
  saves ``conv_general_dilated`` and ``dot_general``."""
  aten = torch.ops.aten
  return op in (aten.convolution.default, aten.mm.default,
                aten.addmm.default, aten.bmm.default)


class _SaveMatmuls(TorchDispatchMode):
  """The region's forward: keeps the outputs of `_matmul_saveable` ops
  in call order."""

  def __init__(self, saved: list):
    super().__init__()
    self.saved = saved

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    out = func(*args, **(kwargs or {}))
    if _matmul_saveable(func):
      self.saved.append((out.detach(), out._version))
    return out


class _ReuseMatmuls(TorchDispatchMode):
  """A recompute of the region: hands back the saved outputs in the same
  order instead of running those ops again.  Unlike
  ``torch.utils.checkpoint.create_selective_checkpoint_contexts``, whose
  cache serves one backward, every recompute starts over, so both pulls
  of the joint step (`engine.xmc_gan`) can run through the region."""

  def __init__(self, saved: list):
    super().__init__()
    self.saved = saved
    self.index = 0

  def __enter__(self):
    self.index = 0
    return super().__enter__()

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    if not _matmul_saveable(func):
      return func(*args, **(kwargs or {}))
    out, version = self.saved[self.index]
    self.index += 1
    if out._version != version:
      raise RuntimeError("an output saved for remat was modified in place")
    return out


def _conv_saving_contexts():
  saved = []
  return _SaveMatmuls(saved), _ReuseMatmuls(saved)


def _maybe_remat(config, block: nn.Module, resolution: int) -> nn.Module:
  """Marks ``block`` (whose largest feature-map side is ``resolution``)
  for recompute when the configuration asks for it; returns it.

  ``remat_policy`` is validated even where the block is not rematted.
  """
  policy = config.get("remat_policy", "full")
  if policy not in ("full", "conv"):
    raise ValueError(f"Unknown remat_policy: {policy!r}")
  block.remat_policy = None
  min_res = config.get("remat_min_resolution", 0)
  if config.get("remat", False) and not (min_res and resolution < min_res):
    block.remat_policy = policy
  return block


def _run_block(block: nn.Module, *args: Tensor) -> Tensor:
  """``block(*args)``, recomputed in the backward if it is marked.

  What the forward writes, it writes once.  The spectrally normalized
  kernels are taken before the recomputed region (advancing ``u0`` once)
  and handed in as its inputs, so the recompute computes with the
  forward's sigma; the recompute runs the BatchNorms without writing
  their running averages.  The values are the forward's.
  """
  policy = block.remat_policy
  if policy is None or not torch.is_grad_enabled():
    return block(*args)
  layers = [m for m in block.modules() if getattr(m, "spectral", False)]
  kernels = [m.normalized_kernel() for m in layers]
  calls = []

  def run(*inputs):
    recompute = contextlib.nullcontext() if not calls else (
        frozen_batch_stats(block))
    calls.append(None)
    with precomputed_kernels(layers, inputs[len(args):]), recompute:
      return block(*inputs[:len(args)])

  context_fn = (_conv_saving_contexts if policy == "conv"
                else torch_checkpoint.noop_context_fn)
  # The blocks draw no random numbers: no RNG state to keep.
  return torch_checkpoint.checkpoint(run, *args, *kernels,
                                     use_reentrant=False,
                                     preserve_rng_state=False,
                                     context_fn=context_fn)


class Generator(nn.Module):
  """Text-conditional generator.

  ``forward(cond, z)``: ``cond`` holds ``sentence_embedding [B, 768]``,
  ``embedding [B, L, 768]`` and ``max_len [B, 1]``; ``z`` is ``[B, z_dim]``.
  Returns images in ``[0, 1]``, ``[B, S, S, 3]``.  Train mode uses batch
  statistics and advances the spectral layers' ``u0`` (see
  `ops.normalization.frozen_state`).  ``fused`` says which layout it
  has.  Sub-modules carry flax's names: with
  ``g_spectral_norm`` ``SpectralDense_0/1`` and ``SpectralConv_0/1`` for
  ``Dense_0/1`` and ``Conv_0/1``.
  """

  def __init__(self, config, *, device=None,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    _check_supported(config)
    self.config = config
    self.dtype = compute_dtype(config)
    spectral = bool(config.g_spectral_norm)
    # The fused modulation is the reference layout's function only with
    # plain 1x1 convs: a spectral G takes the reference layout.
    self.fused = bool(config.get("fused_spatial_cond", True)
                      and not spectral)
    kw = dict(dtype=self.dtype, device=device, generator=generator)
    layer_kw = dict(kw, spectral=spectral)
    norm_kw = dict(kw, norm_group_size=int(
        config.get("batch_norm_group_size", -1)))
    block_kw = dict(norm_kw,
                    scale_fuse=bool(config.get("scale_fused_convs", False)))
    gf = config.gf_dim
    z_dim = config.z_dim
    channels = _GEN_CHANNELS[config.image_size]
    cond = 2 * z_dim  # projected sentence concat z
    dense = "SpectralDense" if spectral else "Dense"
    conv = blocks.conv_prefix(spectral)
    self._names = (f"{dense}_0", f"{dense}_1", f"{conv}_0", f"{conv}_1")

    self.add_module(self._names[0], Dense(BERT_DIM, z_dim, **layer_kw))
    self.add_module(self._names[1],
                    Dense(z_dim, gf * 16 * 4 * 4, **layer_kw))
    in_ch = gf * 16
    # Block i's output side is 4 * 2 ** (i + 1), as in the JAX package.
    for i in range(2):
      self.add_module(f"GenBlock_{i}", _maybe_remat(config, blocks.GenBlock(
          in_ch, gf * channels[i], cond, spectral=spectral, **block_kw),
          4 * 2 ** (i + 1)))
      in_ch = gf * channels[i]
    self.add_module(self._names[2],
                    Conv(in_ch, BERT_DIM, (1, 1), **layer_kw))
    self.spatial_blocks = []
    factor = 1
    for i in range(2, len(channels)):
      if self.fused:
        name = f"GenSpatialBlockFused_{i - 2}"
        block = blocks.GenSpatialBlockFused(
            in_ch, gf * channels[i], BERT_DIM, cond, factor, **block_kw)
        factor *= 2
      else:
        name = f"GenSpatialBlock_{i - 2}"
        block = blocks.GenSpatialBlock(in_ch, gf * channels[i],
                                       BERT_DIM + cond, spectral=spectral,
                                       **block_kw)
      self.add_module(name, _maybe_remat(config, block, 4 * 2 ** (i + 1)))
      self.spatial_blocks.append(block)
      in_ch = gf * channels[i]
    if self.fused:
      self.FusedSpatialModulation_0 = FusedSpatialModulation(
          in_ch, BERT_DIM, cond, factor,
          group_size=norm_kw["norm_group_size"], **kw)
    else:
      self.LocalConditionalBatchNorm_0 = LocalConditionalBatchNorm(
          in_ch, BERT_DIM + cond, group_size=norm_kw["norm_group_size"],
          **layer_kw)
    self.add_module(self._names[3], Conv(in_ch, 3, (3, 3), **layer_kw))

  def forward(self, cond: Dict[str, Tensor], z: Tensor) -> Tensor:
    config = self.config
    dense_sentence, dense_seed, region_conv, out_conv = (
        getattr(self, name) for name in self._names)
    sentence = cond["sentence_embedding"]
    word_feat = cond["embedding"]
    batch, total_len, embedding_dim = word_feat.shape
    z = z.to(self.dtype)
    global_cond = torch.cat([dense_sentence(sentence.to(self.dtype)), z], -1)
    x = dense_seed(z).reshape(batch, 4, 4, -1).permute(0, 3, 1, 2)
    x = _run_block(self.GenBlock_0, x, global_cond)
    x = _run_block(self.GenBlock_1, x, global_cond)

    # Word-region attention at 16x16.
    region = region_conv(x)
    side = region.shape[2]
    region = region.permute(0, 2, 3, 1).reshape(batch, side * side,
                                                 embedding_dim)
    mask = attn_ops.padding_mask(cond["max_len"], total_len)
    region_context, _ = attn_ops.attention_for_g(
        region, word_feat, config.gamma_for_g, mask)
    region_context = region_context.reshape(
        batch, side, side, embedding_dim).permute(0, 3, 1, 2).to(self.dtype)

    if self.fused:
      for block in self.spatial_blocks:
        x = _run_block(block, x, region_context, global_cond)
      x = self.FusedSpatialModulation_0(x, region_context, global_cond)
    else:
      # The reference layout: concat(region context, tiled global
      # conditioning), upsampled once a block.
      spatial_cond = torch.cat([region_context, global_cond[:, :, None, None]
                                .expand(-1, -1, side, side)], dim=1)
      for block in self.spatial_blocks:
        spatial_cond_up = upsample(spatial_cond)
        x = _run_block(block, x, spatial_cond, spatial_cond_up)
        spatial_cond = spatial_cond_up
      x = self.LocalConditionalBatchNorm_0(x, spatial_cond)
    x = torch.tanh(out_conv(F.relu(x)))
    return ((x + 1.0) / 2.0).permute(0, 2, 3, 1)


class Discriminator(nn.Module):
  """Projection discriminator with the five contrastive heads.

  ``forward(images, cond)``: ``images`` is ``concat([real, fake])`` NHWC.
  Returns ``(logit [2B, 1], stats)`` with the 15 statistics of
  `STAT_NAMES`.  With ``critic_only`` the heads whose losses the critic
  step does not use (fake word, fake sentence, image) are skipped and
  their statistics are zero: the critic loss is the same number.
  """

  def __init__(self, config, *, device=None,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    _check_supported(config)
    self.config = config
    self.dtype = compute_dtype(config)
    spectral = bool(config.d_spectral_norm)
    kw = dict(dtype=self.dtype, device=device, generator=generator)
    df = config.df_dim
    fuse = bool(config.get("scale_fused_convs", False))
    channels = _DISC_CHANNELS[config.image_size]
    downsamples = _DISC_DOWNSAMPLE[config.image_size]

    # Remat sides as in the JAX package: the image size for the first
    # block, then each block's input side.
    self.DiscOptimizedBlock_0 = _maybe_remat(config, blocks.DiscOptimizedBlock(
        3, df, spectral=spectral, scale_fuse=fuse, **kw), config.image_size)
    in_ch, resolution, cond_ch = df, config.image_size // 2, None
    self.disc_blocks = []
    for i, (ratio, down) in enumerate(zip(channels, downsamples)):
      block = _maybe_remat(config, blocks.DiscBlock(
          in_ch, df * ratio, down, spectral=spectral, scale_fuse=fuse, **kw),
          resolution)
      self.add_module(f"DiscBlock_{i}", block)
      self.disc_blocks.append(block)
      in_ch = df * ratio
      resolution //= 2 if down else 1
      if resolution == config.cond_size:
        cond_ch = in_ch  # the last block output at cond_size x cond_size
    # flax names: SpectralDense_0 (logit), SpectralDense_1 (sentence
    # projection), SpectralConv_0 (word regions); without spectral norm,
    # Dense_* and Conv_0.
    dense = "SpectralDense" if spectral else "Dense"
    self._names = (f"{dense}_0", f"{dense}_1",
                   f"{blocks.conv_prefix(spectral)}_0")
    self.add_module(self._names[0],
                    Dense(in_ch, 1, spectral=spectral, **kw))
    self.add_module(self._names[1],
                    Dense(BERT_DIM, in_ch, spectral=spectral, **kw))
    if config.word_contrastive:
      self.add_module(self._names[2], Conv(cond_ch, BERT_DIM, (1, 1),
                                           spectral=spectral, **kw))

  def forward(self, images: Tensor, cond: Dict[str, Tensor],
              critic_only: bool = False) -> Tuple[Tensor, Dict[str, Tensor]]:
    config = self.config
    use_pallas = bool(config.get("use_pallas", False))
    # -1: the global batch's pool; > 0: contiguous groups of examples.
    group = int(config.get("contrastive_group_size", -1))
    x = images.permute(0, 3, 1, 2).to(self.dtype)
    x = _run_block(self.DiscOptimizedBlock_0, x)
    x_cond = None
    for block in self.disc_blocks:
      x = _run_block(block, x)
      if x.shape[2] == config.cond_size:
        x_cond = x
    x_pool = F.relu(x).sum(dim=(2, 3))

    dense_logit, dense_sentence, region_conv = (
        getattr(self, name, None) for name in self._names)
    out = dense_logit(x_pool)
    sent_cond = dense_sentence(
        cond["sentence_embedding"].to(self.dtype))
    tile_num = x_pool.shape[0] // sent_cond.shape[0]
    out = out + (x_pool * sent_cond.repeat(tile_num, 1)).sum(
        dim=1, keepdim=True)

    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    stats = {name: zero for name in STAT_NAMES}
    real_pool, fake_pool = x_pool.chunk(2)

    def put(prefix, values):
      for metric, v in zip(("loss", "acc", "entropy"), values):
        stats[f"{prefix}_{metric}"] = v

    if config.sentence_contrastive:
      if not critic_only:
        put("fake_sentence", contrastive_ops.nt_xent(
            fake_pool, sent_cond, use_pallas=use_pallas, group_size=group))
      put("real_sentence", contrastive_ops.nt_xent(
          real_pool, sent_cond, use_pallas=use_pallas, group_size=group))
    if config.word_contrastive:
      region = region_conv(x_cond)
      region = region.permute(0, 2, 3, 1).reshape(
          region.shape[0], -1, region.shape[1])
      real_region, fake_region = region.chunk(2)
      word_feat, max_len = cond["embedding"], cond["max_len"]
      if not critic_only:
        put("fake_word", attn_ops.word_loss(
            fake_region, word_feat, max_len, use_pallas=use_pallas,
            group_size=group))
      put("real_word", attn_ops.word_loss(
          real_region, word_feat, max_len, use_pallas=use_pallas,
          group_size=group))
    if config.image_contrastive and not critic_only:
      put("image_contrastive", contrastive_ops.nt_xent(
          fake_pool, real_pool, use_pallas=use_pallas, group_size=group))
    return out, stats

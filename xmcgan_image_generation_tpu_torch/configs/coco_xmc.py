"""Default XMC-GAN configuration for COCO-2014, in plain Python.

The same keys and values as the JAX package's ``configs/coco_xmc.py``
(`get_config`, `get_test_config`).  That file builds an
``ml_collections.ConfigDict``; this one builds a `Config`, a dict with
attribute access, so that the port needs no package beyond PyTorch.  The
comments on each knob live in the JAX file.
"""

from __future__ import annotations


class Config(dict):
  """A dict whose keys are also attributes (``config.batch_size``)."""

  def __getattr__(self, name):
    try:
      return self[name]
    except KeyError as e:
      raise AttributeError(name) from e

  def __setattr__(self, name, value):
    self[name] = value


def get_config(config_string: str = "") -> Config:
  """Default hyperparameters (COCO-2014, 128px); ``"test"`` gives the
  small smoke-test configuration."""
  if config_string == "test":
    return get_test_config()
  if config_string not in ("", "default"):
    raise ValueError(f"Unknown config variant {config_string!r}")
  return Config(
      seed=42,
      eval_num=30000,
      eval_avg_num=3,
      num_train_steps=-1,
      log_loss_every_steps=1000,
      eval_every_steps=1000,
      checkpoint_every_steps=5000,
      dataset="mscoco",
      coco_version="2014",
      data_dir="data/",
      return_text=False,
      return_filename=False,
      trial=0,
      beta1=0.5,
      beta2=0.999,
      d_lr=0.0004,
      g_lr=0.0001,
      lr_schedule="constant",
      lr_warmup_steps=0,
      lr_decay_steps=0,
      polyak_decay=0.999,
      show_num=64,
      shuffle_buffer_size=1000,
      batch_norm_group_size=-1,
      dtype="bfloat16",
      train_shuffle=True,
      image_size=128,
      batch_size=56,
      eval_batch_size=56,
      df_dim=96,
      gf_dim=96,
      z_dim=128,
      num_epochs=500,
      model_name="xmc",
      d_step_per_g_step=2,
      g_spectral_norm=False,
      d_spectral_norm=True,
      architecture="xmc_net",
      gamma_for_g=15,
      word_contrastive=True,
      sentence_contrastive=True,
      image_contrastive=True,
      pretrained_image_contrastive=True,
      cond_size=16,
      mesh_data=-1,
      mesh_model=1,
      use_pallas=True,
      image_uint8=True,
      contrastive_group_size=-1,
      data_source="tfrecord",
      augment_method="shift",
      resnet_ckpt_path="",
      inception_ckpt_path="",
      grain_worker_count=8,
      profile=False,
      remat=False,
      remat_min_resolution=0,
      remat_policy="full",
      grad_accum_steps=1,
      fused_spatial_cond=True,
      scale_fused_convs=True,
      upconv_method="dilated",
      conv_backward="xla",
      prefetch_batches=2,
  )


def get_test_config() -> Config:
  """Small configuration for CPU smoke tests (as the JAX file's)."""
  config = get_config()
  config.update(
      batch_size=2,
      eval_batch_size=2,
      eval_num=2,
      eval_avg_num=1,
      num_train_steps=2,
      log_loss_every_steps=1,
      eval_every_steps=1,
      checkpoint_every_steps=1,
      df_dim=16,
      gf_dim=16,
      z_dim=8,
      image_size=32,
      show_num=4,
      num_epochs=1,
      shuffle_buffer_size=10,
      data_source="synthetic",
      pretrained_image_contrastive=False,
      grain_worker_count=0,
      use_pallas=False,
      scale_fused_convs=False,
  )
  return config

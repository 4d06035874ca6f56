"""Frozen ResNet-50 tower for the pretrained image-image contrastive loss
(the JAX package's ``utils/pretrained.py``).

With no checkpoint the tower is randomly initialized, as the JAX package
does for ``resnet_ckpt_path=""``.  The ``.npy`` loader is not ported yet:
no weights ship with the repository.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from xmcgan_image_generation_tpu_torch.models import resnet_v1

RESNET_IMG_SIZE = 224


def get_pretrained_model(model_name: str = "resnet50",
                         checkpoint_path: str = "",
                         dtype=torch.bfloat16, device=None,
                         seed: int = 42) -> resnet_v1.ResNet:
  """The frozen tower in eval mode, weights without gradients."""
  if model_name != "resnet50":
    raise ValueError(f"Model {model_name!r} not supported.")
  if checkpoint_path:
    raise NotImplementedError(
        "loading pretrained ResNet weights is not ported yet (ROADMAP)")
  generator = torch.Generator().manual_seed(seed)
  model = resnet_v1.ResNet50(num_classes=1000, dtype=dtype, device=device,
                             generator=generator)
  model.eval()
  model.requires_grad_(False)
  return model


def get_pretrained_embs(model: resnet_v1.ResNet, images: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Frozen inference on NHWC images: ``(7x7x2048 features, logits)``.

  Resizes to 224x224 bilinearly (half-pixel centers, as
  ``jax.image.resize``) when needed.  Gradients flow to the images.
  """
  if images.dim() != 4 or images.shape[-1] != 3:
    raise ValueError("images should be of shape (N, H, W, 3).")
  if images.shape[1:3] != (RESNET_IMG_SIZE, RESNET_IMG_SIZE):
    images = F.interpolate(
        images.float().permute(0, 3, 1, 2),
        size=(RESNET_IMG_SIZE, RESNET_IMG_SIZE), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
  return model(images)

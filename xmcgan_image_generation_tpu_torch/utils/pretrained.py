"""Frozen ResNet-50 tower for the pretrained image-image contrastive loss
(the JAX package's ``utils/pretrained.py``).

With no checkpoint the tower is randomly initialized, as the JAX package
does for ``resnet_ckpt_path=""``.  A checkpoint is the JAX package's
``.npy`` file: a pickled ``{"params": ..., "batch_stats": ...}`` dict in
its flat ``stage{i}_block{j}`` layout or the reference's nested
``stage{i}/block{j}`` one, with numpy or ``jax.Array`` leaves, under
plain dicts or flax ``FrozenDict``s.  `load_npy_tree` reads it without
JAX or flax: a restricted unpickler maps the few classes such a file
holds to numpy and ``dict`` and refuses every other.
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from xmcgan_image_generation_tpu_torch.models import resnet_v1
from xmcgan_image_generation_tpu_torch.utils import bridge

RESNET_IMG_SIZE = 224

# numpy's array reconstructor (``numpy._core.multiarray._reconstruct``;
# ``numpy.core.multiarray`` before numpy 2), whichever this numpy has.
_NP_RECONSTRUCT = np.empty(0).__reduce__()[0]


def _jax_array(fun, args, arr_state, aval_state):
  """Stands in for ``jax._src.array._reconstruct_array``: the numpy array
  that a pickled ``jax.Array`` carries (its ``__reduce__`` pickles the
  host value's own reduction)."""
  del aval_state  # weak_type only
  value = fun(*args)
  value.__setstate__(arr_state)
  return value


_CLASSES = {
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("numpy._core.multiarray", "_reconstruct"): _NP_RECONSTRUCT,
    ("numpy.core.multiarray", "_reconstruct"): _NP_RECONSTRUCT,
    ("flax.core.frozen_dict", "FrozenDict"): dict,
    ("jax._src.array", "_reconstruct_array"): _jax_array,
}


class _TreeUnpickler(pickle.Unpickler):
  """Unpickles a tree of arrays; any class outside `_CLASSES` raises."""

  def find_class(self, module, name):
    try:
      return _CLASSES[(module, name)]
    except KeyError:
      raise pickle.UnpicklingError(
          f"{module}.{name} is not allowed in a tower checkpoint") from None


def load_npy_tree(path: str) -> Dict[str, Any]:
  """The ``{"params", "batch_stats"}`` dict of a JAX ``.npy`` checkpoint
  (what ``np.load(path, allow_pickle=True).item()`` gives with JAX
  installed), with numpy leaves."""
  readers = {(1, 0): np.lib.format.read_array_header_1_0,
             (2, 0): np.lib.format.read_array_header_2_0}
  with open(path, "rb") as f:
    version = np.lib.format.read_magic(f)
    if version not in readers:
      raise ValueError(f"{path}: .npy format version {version} is not "
                       f"supported")
    shape, _, dtype = readers[version](f)
    if shape != () or not dtype.hasobject:
      raise ValueError(f"{path}: holds a {dtype} array of shape {shape}, "
                       f"not a pickled dict")
    try:
      data = _TreeUnpickler(f).load().item()
    except pickle.UnpicklingError as e:
      raise ValueError(f"{path}: {e}") from None
  if not (isinstance(data, Mapping)
          and {"params", "batch_stats"} <= set(data)):
    raise ValueError(f"{path}: not a {{'params', 'batch_stats'}} dict")
  return dict(data)


def _flatten_reference_stages(tree: Mapping[str, Any]) -> Dict[str, Any]:
  """The reference's ``stage{i} -> block{j} -> ...`` nesting as the
  tower's ``stage{i}_block{j}``; a flat tree passes through."""
  out = {}
  for key, value in tree.items():
    if (re.fullmatch(r"stage\d+", key) and isinstance(value, Mapping)
        and value and all(re.fullmatch(r"block\d+", b) for b in value)):
      for block, sub in value.items():
        out[f"{key}_{block}"] = sub
    else:
      out[key] = value
  return out


def get_pretrained_model(model_name: str = "resnet50",
                         checkpoint_path: str = "",
                         dtype=torch.bfloat16, device=None,
                         seed: int = 42) -> resnet_v1.ResNet:
  """The frozen tower in eval mode, weights without gradients: loaded
  from ``checkpoint_path`` when given (every path of the file must match
  the tower's, with its shape), else randomly initialized from ``seed``."""
  if model_name != "resnet50":
    raise ValueError(f"Model {model_name!r} not supported.")
  generator = torch.Generator().manual_seed(seed)
  model = resnet_v1.ResNet50(num_classes=1000, dtype=dtype, device=device,
                             generator=generator)
  if checkpoint_path:
    data = load_npy_tree(checkpoint_path)
    variables = {c: _flatten_reference_stages(data[c])
                 for c in ("params", "batch_stats")}
    try:
      bridge.load_jax_variables(model, variables)
    except ValueError as e:
      raise ValueError(f"{checkpoint_path}: {e}") from None
  model.eval()
  model.requires_grad_(False)
  return model


def resize_for_tower(images: torch.Tensor) -> torch.Tensor:
  """NHWC images at 224 x 224 as ``jax.image.resize(..., "bilinear")``
  gives them: half-pixel centers, and a triangle filter widened by the
  scale (antialiasing) where a side shrinks.  ``F.interpolate`` matches
  JAX when it antialiases only on the way down; its antialiased path
  differs by some 4e-6 on the way up (128 -> 224)."""
  if images.shape[1:3] == (RESNET_IMG_SIZE, RESNET_IMG_SIZE):
    return images
  shrinks = max(images.shape[1:3]) > RESNET_IMG_SIZE
  return F.interpolate(
      images.float().permute(0, 3, 1, 2),
      size=(RESNET_IMG_SIZE, RESNET_IMG_SIZE), mode="bilinear",
      align_corners=False, antialias=shrinks).permute(0, 2, 3, 1)


def get_pretrained_embs(model, images: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Frozen inference on NHWC images: ``(7x7x2048 features, logits)``,
  resized by `resize_for_tower` when needed.  Gradients flow to the
  images."""
  if images.dim() != 4 or images.shape[-1] != 3:
    raise ValueError("images should be of shape (N, H, W, 3).")
  return model(resize_for_tower(images))

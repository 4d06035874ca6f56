"""Per-example preprocessing: decode, resize, flip, augment, caption pick
(the JAX package's ``data/preprocessing.py``).

The same functions with Pillow's decode and bilinear resize replaced by
`data.png` and `data.resize`, which give the same bytes.  Every random
choice draws from the per-example `np.random.Generator` the loader hands
in, in the JAX package's order: flip, then augment, then the caption
index, then ``z``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from xmcgan_image_generation_tpu_torch.data import png
from xmcgan_image_generation_tpu_torch.data import resize

Example = Dict[str, np.ndarray]


def decode_png(data: bytes, name: str = "PNG") -> np.ndarray:
  """PNG bytes -> float32 RGB array in [0, 1]."""
  return png.decode(data, name).astype(np.float32) / 255.0


def decode_resize_uint8(data: bytes, height: int, width: int,
                        name: str = "PNG") -> np.ndarray:
  """PNG bytes -> uint8 RGB array resized bilinearly."""
  return resize_uint8(png.decode(data, name), height, width)


def resize_bilinear(image: np.ndarray, height: int, width: int) -> np.ndarray:
  """Bilinear resize of a [H, W, C] float image in [0, 1] (through uint8,
  as Pillow's)."""
  if image.shape[0] == height and image.shape[1] == width:
    return image.astype(np.float32)
  quantized = np.clip(image * 255.0 + 0.5, 0, 255).astype(np.uint8)
  return resize.resize_uint8(quantized, height, width).astype(
      np.float32) / 255.0


def resize_uint8(image: np.ndarray, height: int, width: int) -> np.ndarray:
  """Bilinear resize of a [H, W, C] uint8 image, staying uint8."""
  if image.shape[0] == height and image.shape[1] == width:
    return image
  return resize.resize_uint8(image, height, width)


def random_flip(image: np.ndarray, rng: np.random.Generator) -> np.ndarray:
  if rng.random() < 0.5:
    return image[:, ::-1, :]
  return image


def augment_shift(image: np.ndarray, rng: np.random.Generator,
                  w: int = 4) -> np.ndarray:
  """Pad-4-reflect + random crop."""
  h, wid, _ = image.shape
  padded = np.pad(image, ((w, w), (w, w), (0, 0)), mode="reflect")
  dy = int(rng.integers(0, 2 * w + 1))
  dx = int(rng.integers(0, 2 * w + 1))
  return padded[dy:dy + h, dx:dx + wid, :]


def augment_zoom_crop(image: np.ndarray, rng: np.random.Generator,
                      zoom_ratio: float = 1.125) -> np.ndarray:
  """x1.125 zoom + random crop."""
  h, w, _ = image.shape
  new_h, new_w = int(h * zoom_ratio), int(w * zoom_ratio)
  if image.dtype == np.uint8:
    zoomed = resize_uint8(image, new_h, new_w)
  else:
    zoomed = resize_bilinear(image, new_h, new_w)
  dy = int(rng.integers(0, new_h - h + 1))
  dx = int(rng.integers(0, new_w - w + 1))
  return zoomed[dy:dy + h, dx:dx + w, :]


def augment(image: np.ndarray, rng: np.random.Generator,
            method: str = "shift", flip: bool = True) -> np.ndarray:
  """DiffAug-style augmentation."""
  if method == "shift":
    image = augment_shift(image, rng)
  elif method == "zoom_crop":
    image = augment_zoom_crop(image, rng)
  else:
    raise NotImplementedError(
        f"{method} is not supported for data augmentation.")
  if flip:
    image = random_flip(image, rng)
  return image


def preprocess_example(
    features: Dict[str, np.ndarray],
    rng: np.random.Generator,
    *,
    image_size: int,
    z_dim: int,
    sentence_num: int = 5,
    return_text: bool = False,
    return_filename: bool = False,
    augment_method: str = "shift",
    dtype: np.dtype = np.float32,
    image_uint8: bool = True,
    name: str = "PNG",
) -> Example:
  """Raw record features -> training example.

  Resize, flip and clip, an augmented copy, per-caption sentence
  embeddings as the length-normalized word sums, a random caption (the
  shortest with ``return_text``, the evaluation protocol), and ``z``.
  ``features`` carries ``image`` (a float array or PNG bytes),
  ``caption/embedding [sentence_num, L, D]``, ``caption/max_len
  [sentence_num]`` and optionally ``caption/text``; ``name`` names the
  record in a decode error.  With ``image_uint8`` (the default) ``image``
  and ``image_aug`` stay uint8.
  """
  image = features["image"]
  if image_uint8:
    if isinstance(image, (bytes, bytearray)):
      image = decode_resize_uint8(image, image_size, image_size, name)
    else:
      image = np.clip(np.asarray(image, np.float32), 0.0, 1.0)
      image = np.clip(image * 255.0 + 0.5, 0, 255).astype(np.uint8)
      image = resize_uint8(image, image_size, image_size)
    image = random_flip(image, rng)
    image_aug = augment(image, rng, method=augment_method)
    image = np.ascontiguousarray(image)
    image_aug = np.ascontiguousarray(image_aug)
  else:
    if isinstance(image, (bytes, bytearray)):
      image = decode_png(image, name)
    image = resize_bilinear(image, image_size, image_size)
    image = random_flip(image, rng)
    image = np.clip(image, 0.0, 1.0)
    image_aug = augment(image, rng, method=augment_method)

  embedding = np.asarray(features["caption/embedding"], np.float32)
  max_len = np.asarray(features["caption/max_len"], np.float32)
  max_len = max_len.reshape(sentence_num, 1)
  sentence_feat = embedding.sum(axis=-2) / max_len  # [sentence_num, D]
  if return_text:
    idx = int(np.argmin(max_len[:, 0]))
  else:
    idx = int(rng.integers(0, sentence_num))

  out: Example = {
      "image": image if image_uint8 else image.astype(dtype),
      "image_aug": image_aug if image_uint8 else image_aug.astype(dtype),
      "embedding": embedding[idx].astype(dtype),
      "max_len": max_len[idx].astype(dtype),
      "sentence_embedding": sentence_feat[idx].astype(dtype),
      "z": rng.standard_normal(z_dim).astype(dtype),
  }
  if return_text:
    text = features.get("caption/text")
    out["text"] = (text[idx] if text is not None else b"")
  if return_filename:
    out["filename"] = features.get("image/filename", [b""])[0]
  return out

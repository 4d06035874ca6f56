"""Random-access data sources of the loader (the JAX package's
``data/sources.py``).

* `COCORecordSource`: the COCO TFRecord shards in the JAX package's
  schema (``tools/preprocess_coco.py`` writes them), read at random.
* `SyntheticXMCSource`: deterministic random examples in the same schema,
  the same arrays as the JAX package's for the same seed and index.
"""

from __future__ import annotations

import bisect
import glob
import os
from typing import Dict

import numpy as np

from xmcgan_image_generation_tpu_torch.data import records

# Split sizes (the reference's libml/coco_dataset.py).
COCO_NUM_EXAMPLES = {
    "2014": {"train": 82_783, "val": 40_504},
    "2017": {"train": 116_680, "val": 4_958},
    "ln": {"train": 134_272, "val": 8_573},  # Localized Narratives.
}


class COCORecordSource:
  """Random-access source over a glob of TFRecord shards.

  Returns the parsed record: ``caption/embedding [n_caps, L, bert_dim]``,
  ``caption/max_len [n_caps]``, ``caption/text`` and ``image/filename``
  when present, ``image`` (the PNG bytes, which the loader's transform
  decodes and resizes in one go) and ``record``, ``"<shard>#<index>"``,
  which names the record in a decode error.
  """

  def __init__(self, file_pattern: str, bert_dim: int = 768):
    self._pattern = file_pattern
    self._bert_dim = bert_dim
    # The reader's own ``.idx`` sidecars match the shard glob too.
    paths = sorted(p for p in glob.glob(file_pattern)
                   if not p.endswith(".idx"))
    if not paths:
      raise FileNotFoundError(
          f"No TFRecord shards match {file_pattern!r}")
    self._files = [records.TFRecordFile(p) for p in paths]
    self._cum = np.cumsum([0] + [len(f) for f in self._files])

  def __repr__(self) -> str:
    return (f"COCORecordSource(pattern={self._pattern!r}, "
            f"files={len(self._files)}, records={len(self)})")

  def __len__(self) -> int:
    return int(self._cum[-1])

  def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
    index = int(index)
    shard = bisect.bisect_right(self._cum, index) - 1
    file = self._files[shard]
    local = index - int(self._cum[shard])
    feats = records.parse_example(file.read(local))
    out = {
        "caption/embedding": np.asarray(
            feats["caption/embedding"], np.float32),
        "caption/max_len": np.asarray(feats["caption/max_len"], np.float32),
        "record": f"{file.path}#{local}",
    }
    n_caps = out["caption/max_len"].shape[0]
    out["caption/embedding"] = out["caption/embedding"].reshape(
        n_caps, -1, self._bert_dim)
    out["image"] = feats["image"][0]
    if "caption/text" in feats:
      out["caption/text"] = feats["caption/text"]
    if "image/filename" in feats:
      out["image/filename"] = feats["image/filename"]
    return out


def coco_file_pattern(data_dir: str, coco_version: str, split: str) -> str:
  """Shard glob of a split: ``{data_dir}/*{version}*{train|validation}
  .tfrecord*``."""
  if split not in ("train", "val"):
    raise ValueError(f"Expected split in ['train', 'val'], got {split!r}")
  name = "validation" if split == "val" else split
  return os.path.join(data_dir, f"*{coco_version}*{name}.tfrecord*")


class SyntheticXMCSource:
  """Deterministic random examples with the COCO record schema.

  Example ``i`` is always the same arrays (seeded by ``(seed, i)``), with
  image sizes from ``min_size`` to ``max_size`` to exercise the resize.
  """

  def __init__(self, num_examples: int = 64, seed: int = 0,
               sentence_num: int = 5, text_len: int = 17,
               bert_dim: int = 768, min_size: int = 32, max_size: int = 48):
    self._n = num_examples
    self._seed = seed
    self._sentence_num = sentence_num
    self._text_len = text_len
    self._bert_dim = bert_dim
    self._min_size = min_size
    self._max_size = max_size

  def __repr__(self) -> str:
    return f"SyntheticXMCSource(n={self._n}, seed={self._seed})"

  def __len__(self) -> int:
    return self._n

  def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng((self._seed, int(index)))
    h = int(rng.integers(self._min_size, self._max_size + 1))
    w = int(rng.integers(self._min_size, self._max_size + 1))
    return {
        "image": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
        "caption/embedding": rng.standard_normal(
            (self._sentence_num, self._text_len, self._bert_dim)
        ).astype(np.float32),
        "caption/max_len": rng.integers(
            3, self._text_len + 1, (self._sentence_num,)
        ).astype(np.float32),
        "caption/text": [b"synthetic caption"] * self._sentence_num,
        "image/filename": [b"synthetic.png"],
    }

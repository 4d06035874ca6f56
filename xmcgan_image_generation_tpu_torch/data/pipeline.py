"""The input pipeline: deterministic, resumable loaders of train
super-batches and eval batches (the JAX package's ``data/pipeline.py``,
which builds them with grain; the card's machine has no grain).

The semantics are grain's for one process, so the batches equal the JAX
package's for the same records, configuration and seed:

* The example at global position ``i`` is record ``keys[i]``: ``i`` modulo
  the record count ``n``, or, with ``train_shuffle``, that index permuted
  as grain's C++ ``index_shuffle`` does, with the seed ``(seed + epoch) %
  2**32`` and 4 rounds (`index_shuffle`).  Its random draws come from
  ``np.random.Generator(np.random.Philox(key=seed + i))``, as grain's
  ``IndexSampler`` gives each record.
* With ``worker_count`` workers, grain hands position ``i`` to worker
  ``i % worker_count``, which batches its own positions in order, and the
  batches are taken from the workers in turn.  Batch ``b`` is therefore
  the ``b // worker_count``-th batch of worker ``b % worker_count`` (with 0
  workers, positions ``b * size`` onwards).  The port forms the same
  batches, so a batch's examples depend on the worker count, as they do
  in grain, and on nothing else.
* Batches of ``batch_size * d_step_per_g_step`` (train) or
  ``eval_batch_size`` (eval) drop no remainder: the loaders never end.

The state of a loader's iterator is the number of the next batch; the
checkpoint keeps it.  Worker processes (``grain_worker_count``) are
started with ``spawn``: they import numpy and this package's data modules,
never torch, and never touch CUDA.  Each forms whole batches, one ahead
of the batch being taken, as grain's ``worker_buffer_size`` of 1 does.
"""

from __future__ import annotations

import dataclasses
import math
import multiprocessing
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from xmcgan_image_generation_tpu_torch.data import constants
from xmcgan_image_generation_tpu_torch.data import preprocessing
from xmcgan_image_generation_tpu_torch.data import sources

Batch = Dict[str, np.ndarray]

_U32 = 0xFFFFFFFF


def _seed_seq(seed: int, n: int) -> List[int]:
  """``std::seed_seq{seed}.generate`` of ``n`` 32-bit words (the C++
  standard's algorithm)."""
  words = [0x8B8B8B8B] * n
  t = (11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7
       else (n - 1) // 2)
  p = (n - t) // 2
  q = p + t
  m = max(2, n)

  def mix(x):
    return x ^ (x >> 27)

  for k in range(m):
    r1 = 1664525 * mix(words[k % n] ^ words[(k + p) % n]
                       ^ words[(k - 1) % n]) & _U32
    r2 = (r1 + (1 if k == 0 else k % n + seed if k == 1 else k % n)) & _U32
    words[(k + p) % n] = (words[(k + p) % n] + r1) & _U32
    words[(k + q) % n] = (words[(k + q) % n] + r2) & _U32
    words[k % n] = r2
  for k in range(m, m + n):
    r3 = 1566083941 * mix((words[k % n] + words[(k + p) % n]
                           + words[(k - 1) % n]) & _U32) & _U32
    r4 = (r3 - k % n) & _U32
    words[(k + p) % n] ^= r3
    words[(k + q) % n] ^= r4
    words[k % n] = r4
  return words


def index_shuffle(index: np.ndarray, max_index: int, seed: int,
                  rounds: int = 4) -> np.ndarray:
  """grain's C++ ``index_shuffle``: the places of ``index`` (values in
  ``[0, max_index]``) in a pseudorandom permutation of ``[0, max_index]``.
  A Simon cipher on blocks of ``max(16, ceil(log2(max_index)))`` bits
  (rounded up to even), with round keys from ``std::seed_seq{seed}``,
  applied until the value falls in range."""
  index = np.asarray(index, np.uint64)
  if max_index == 0:
    return np.zeros_like(index)
  block = math.ceil(math.log2(max_index))
  w = max(block + block % 2, 16) // 2
  mask = np.uint64((1 << w) - 1)
  keys = [np.uint64(k) & mask for k in _seed_seq(seed & _U32, rounds)]

  def rotl(x, r):
    return ((x << np.uint64(r)) | (x >> np.uint64(w - r))) & mask

  def f(x):
    return (rotl(x, 1) & rotl(x, 8)) ^ rotl(x, 2)

  def encrypt(x):
    left, right = (x >> np.uint64(w)) & mask, x & mask
    for i in range(0, rounds, 2):
      left ^= f(right) ^ keys[i]
      right ^= f(left) ^ keys[i + 1]
    return (left << np.uint64(w)) | right

  if 2 * w <= 24:   # a small domain: encrypt all of it once
    table = encrypt(np.arange(1 << (2 * w), dtype=np.uint64))
    step = lambda x: table[x]  # noqa: E731
  else:
    step = encrypt
  out = index.copy()
  todo = np.ones(out.shape, bool)
  while todo.any():   # walk the cycle until the value is in range
    out[todo] = step(out[todo])
    todo &= out > np.uint64(max_index)
  return out


@dataclasses.dataclass(frozen=True)
class PreprocessTransform:
  """`preprocessing.preprocess_example` with the loader's settings."""

  image_size: int
  z_dim: int
  sentence_num: int = 5
  return_text: bool = False
  return_filename: bool = False
  augment_method: str = "shift"
  image_uint8: bool = True

  def __call__(self, features, rng: np.random.Generator):
    return preprocessing.preprocess_example(
        features,
        rng,
        image_size=self.image_size,
        z_dim=self.z_dim,
        sentence_num=self.sentence_num,
        return_text=self.return_text,
        return_filename=self.return_filename,
        augment_method=self.augment_method,
        image_uint8=self.image_uint8,
        name=features.get("record", "PNG"),
    )


def template_batch(config, batch_size: Optional[int] = None) -> Batch:
  """Zero-filled batch with the loader's shapes and dtypes."""
  n = batch_size or config.eval_batch_size
  s = config.image_size
  text_len = (constants.LN_MAX_TEXT_LENGTH
              if config.dataset == "localized_narratives"
              else constants.COCO_MAX_TEXT_LENGTH)
  d = constants.PRETRAINED_BERT_DIM
  img_dtype = np.uint8 if config.get("image_uint8", True) else np.float32
  return {
      "image": np.zeros((n, s, s, 3), img_dtype),
      "image_aug": np.zeros((n, s, s, 3), img_dtype),
      "embedding": np.zeros((n, text_len, d), np.float32),
      "max_len": np.ones((n, 1), np.float32),
      "sentence_embedding": np.zeros((n, d), np.float32),
      "z": np.zeros((n, config.z_dim), np.float32),
  }


def _build_source(config, split: str):
  if config.data_source == "synthetic":
    n = 64 if split == "train" else 32
    return sources.SyntheticXMCSource(num_examples=n, seed=config.seed)
  if config.data_source == "tfrecord":
    if config.dataset != "mscoco":
      raise ValueError(f"Unsupported dataset {config.dataset!r}")
    pattern = sources.coco_file_pattern(
        config.data_dir, config.coco_version, split)
    return sources.COCORecordSource(pattern)
  raise ValueError(f"Unknown data_source {config.data_source!r}")


class DataLoader:
  """Batches of ``batch_size`` preprocessed examples of ``source``, with
  grain's order and random draws; iterate it for a `LoaderIterator`."""

  def __init__(self, source, transform: PreprocessTransform, *,
               batch_size: int, seed: int, shuffle: bool,
               worker_count: int = 0):
    if len(source) <= 0:
      raise ValueError("the data source holds no records")
    if shuffle and not 0 <= seed < 2**32:
      raise ValueError("the shuffle needs a seed in [0, 2**32)")
    self.source = source
    self.transform = transform
    self.batch_size = batch_size
    self.seed = seed
    self.shuffle = shuffle
    self.worker_count = worker_count
    self._epoch_order: Tuple[int, Optional[np.ndarray]] = (-1, None)

  def __repr__(self) -> str:
    return (f"DataLoader({self.source!r}, batch_size={self.batch_size}, "
            f"seed={self.seed}, shuffle={self.shuffle}, "
            f"worker_count={self.worker_count})")

  def positions(self, batch: int) -> np.ndarray:
    """The global positions of batch number ``batch``'s examples."""
    workers = max(self.worker_count, 1)
    worker, local = batch % workers, batch // workers
    local_positions = local * self.batch_size + np.arange(self.batch_size)
    return worker + workers * local_positions

  def _permutation(self, epoch: int) -> np.ndarray:
    if self._epoch_order[0] != epoch:
      n = len(self.source)
      order = index_shuffle(np.arange(n), n - 1, (self.seed + epoch) % 2**32)
      self._epoch_order = (epoch, order.astype(np.int64))
    return self._epoch_order[1]

  def record_key(self, position: int) -> int:
    epoch, index = divmod(int(position), len(self.source))
    return int(self._permutation(epoch)[index]) if self.shuffle else index

  def example(self, position: int) -> Dict[str, Any]:
    rng = np.random.Generator(np.random.Philox(key=self.seed + int(position)))
    return self.transform(self.source[self.record_key(position)], rng)

  def batch(self, number: int) -> Batch:
    """Batch number ``number``, made here."""
    examples = [self.example(p) for p in self.positions(number)]
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}

  def __iter__(self) -> "LoaderIterator":
    return LoaderIterator(self)


# Batches each worker is asked for ahead of the one being taken (grain's
# ``worker_buffer_size`` is 1).
_BATCHES_AHEAD = 1


def _worker_main(conn, loader: DataLoader) -> None:
  """A worker process: makes each batch whose number arrives on ``conn``
  and sends it back, or the traceback of the error that stopped it."""
  while True:
    number = conn.recv()
    try:
      conn.send(("batch", loader.batch(number)))
    except Exception:  # noqa: BLE001 - raised again in the parent
      conn.send(("error", traceback.format_exc()))
      return


class LoaderIterator:
  """The endless batches of a `DataLoader` from a position, with that
  position as its state.  With ``worker_count`` workers, batch ``b`` is
  made by worker ``b % worker_count`` (spawned at the first batch), and
  each worker is asked for one batch beyond the ones being taken."""

  def __init__(self, loader: DataLoader, position: int = 0):
    self.loader = loader
    self.position = position
    self._workers: List[Tuple[Any, Any]] = []   # (process, connection)
    self._requested = position   # the first batch not yet asked for

  def __iter__(self) -> "LoaderIterator":
    return self

  def _start(self) -> None:
    ctx = multiprocessing.get_context("spawn")
    for _ in range(self.loader.worker_count):
      ours, theirs = ctx.Pipe()
      proc = ctx.Process(target=_worker_main, daemon=True,
                         args=(theirs, self.loader))
      proc.start()
      theirs.close()
      self._workers.append((proc, ours))
    self._requested = self.position

  def __next__(self) -> Batch:
    workers = self.loader.worker_count
    if workers <= 0:
      batch = self.loader.batch(self.position)
    else:
      if not self._workers:
        self._start()
      while self._requested < self.position + workers * _BATCHES_AHEAD:
        self._workers[self._requested % workers][1].send(self._requested)
        self._requested += 1
      worker = self.position % workers
      try:
        kind, batch = self._workers[worker][1].recv()
      except EOFError as e:
        raise RuntimeError(f"loader worker {worker} died") from e
      if kind == "error":
        raise RuntimeError(f"loader worker {worker}, batch "
                           f"{self.position}:\n{batch}")
    self.position += 1
    return batch

  def get_state(self) -> Dict[str, Any]:
    return {"position": self.position, "loader": repr(self.loader)}

  def set_state(self, state: Dict[str, Any]) -> None:
    if state["loader"] != repr(self.loader):
      raise ValueError(f"the checkpoint's loader is {state['loader']}, "
                       f"this one {self.loader!r}")
    self.close()   # the batches asked for belong to the old position
    self.position = int(state["position"])

  def close(self) -> None:
    """Stops the worker processes."""
    for proc, conn in self._workers:
      proc.kill()
      proc.join()
      conn.close()
    self._workers = []


def _make_loader(config, split: str, *, seed: int, batch_size: int,
                 shuffle: bool, return_text: bool) -> DataLoader:
  transform = PreprocessTransform(
      image_size=config.image_size,
      z_dim=config.z_dim,
      return_text=return_text,
      return_filename=config.return_filename,
      augment_method=config.get("augment_method", "shift"),
      image_uint8=config.get("image_uint8", True),
  )
  return DataLoader(_build_source(config, split), transform,
                    batch_size=batch_size, seed=seed, shuffle=shuffle,
                    worker_count=config.get("grain_worker_count", 0))


def create_datasets(config, seed: int) -> Tuple[DataLoader, DataLoader, int]:
  """``(train_loader, eval_loader, num_train_examples)``.

  The train loader yields super-batches of ``batch_size *
  d_step_per_g_step`` examples; the eval loader yields batches of
  ``eval_batch_size`` with the seed ``seed + 1``, unshuffled.  Both
  repeat without end.
  """
  train = _make_loader(
      config, "train", seed=seed,
      batch_size=config.batch_size * config.d_step_per_g_step,
      shuffle=config.train_shuffle, return_text=False)
  evaluation = _make_loader(
      config, "val", seed=seed + 1, batch_size=config.eval_batch_size,
      shuffle=False, return_text=config.return_text)
  return train, evaluation, len(train.source)


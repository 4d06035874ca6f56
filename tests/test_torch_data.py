"""The port's data layer against the JAX package's, on the CPU.

The same numpy-seeded inputs go through both packages: PNG decoding and
bilinear resizing (the port's own decoder and resampler, native and
plain, against Pillow, which the JAX package calls), per-example
preprocessing, TFRecord files read and written across the packages, the
loaders of ``create_datasets`` (the port's against grain's), the
loaders' and the prefetcher's resume, the trainer's step k on the JAX
loader's super-batch k, and, as a whole, the first super-batch of the
records through one training step of each package.

Tolerances: every array of the data layer is compared exactly (uint8
images bit for bit, float features as stored).  The training step's
losses: 1e-4 relative, as in ``test_torch_step.py`` (float32 on both
sides, XLA:CPU and PyTorch sum in other orders).
"""

import functools
import io
import os
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.data import pipeline as j_pipeline
from xmcgan_image_generation_tpu.data import preprocessing as j_prep
from xmcgan_image_generation_tpu.data import records as j_records
from xmcgan_image_generation_tpu.engine import create_train_state as j_state
from xmcgan_image_generation_tpu.engine.step import split_batch as j_split
from xmcgan_image_generation_tpu.engine.step import train_step as j_step
from xmcgan_image_generation_tpu_torch import train as train_lib
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.data import pipeline
from xmcgan_image_generation_tpu_torch.data import png
from xmcgan_image_generation_tpu_torch.data import preprocessing
from xmcgan_image_generation_tpu_torch.data import records
from xmcgan_image_generation_tpu_torch.data import resize
from xmcgan_image_generation_tpu_torch.data.prefetch import DevicePrefetcher
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.engine.step import train_step
from xmcgan_image_generation_tpu_torch.utils import bridge

torch.set_num_threads(1)

COLOR_TYPE = {1: 0, 3: 2, 4: 6}   # samples per pixel -> PNG color type


def _smooth(rng, h, w, channels=3):
  """Low-frequency content plus noise, as natural images."""
  small = rng.integers(0, 256, (max(h // 8, 2), max(w // 8, 2), channels),
                       np.uint8)
  base = resize.resize_uint8_plain(small, h, w).astype(np.int16)
  noisy = base + rng.integers(-6, 7, base.shape)
  return np.clip(noisy, 0, 255).astype(np.uint8)


def _paeth(a, b, c):
  p = a + b - c
  pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
  return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(image, filters=(0, 1, 2, 3, 4)):
  """A PNG whose rows use ``filters`` in turn (8-bit, gray / RGB / RGBA)."""
  h, w = image.shape[:2]
  ch = 1 if image.ndim == 2 else image.shape[2]
  rows, x = [], image.reshape(h, w * ch).astype(np.int32)
  for y in range(h):
    kind = filters[y % len(filters)]
    cur = x[y]
    up = x[y - 1] if y else np.zeros_like(cur)
    left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
    upleft = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
    pred = (0, left, up, (left + up) >> 1, _paeth(left, up, upleft))[kind]
    rows.append(bytes([kind]) + ((cur - pred) & 255).astype(np.uint8)
                .tobytes())

  def chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))

  header = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPE[ch], 0, 0, 0)
  return (png.SIGNATURE + chunk(b"IHDR", header)
          + chunk(b"IDAT", zlib.compress(b"".join(rows)))
          + chunk(b"IEND", b""))


def _pillow_png(image):
  buf = io.BytesIO()
  Image.fromarray(image).save(buf, format="PNG")
  return buf.getvalue()


def _filter_types(data):
  raw, height, width, bpp = png._layout(data, "test")
  rows = np.frombuffer(raw, np.uint8).reshape(height, width * bpp + 1)
  return set(rows[:, 0].tolist())


# ---------------------------------------------------------------------------
# PNG decoding and resizing.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("encoder", ["pillow", "five_filters"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
def test_decode_matches_pillow(encoder, mode):
  rng = np.random.default_rng(["RGB", "RGBA", "L"].index(mode))
  channels = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
  image = _smooth(rng, 37, 53, channels)
  if mode == "L":
    image = image[:, :, 0]
  data = _pillow_png(image) if encoder == "pillow" else encode_png(image)
  if encoder == "five_filters":
    assert _filter_types(data) == {0, 1, 2, 3, 4}
  want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
  for plain in (False, True):
    np.testing.assert_array_equal(png.decode(data, plain=plain), want)
  np.testing.assert_array_equal(preprocessing.decode_png(data),
                                j_prep.decode_png(data))
  for size in ((37, 53), (32, 32), (64, 48)):
    np.testing.assert_array_equal(
        preprocessing.decode_resize_uint8(data, *size),
        j_prep.decode_resize_uint8(data, *size))


@pytest.mark.parametrize("what", ["palette", "16bit", "interlaced"])
def test_unsupported_png_raises_naming_the_record(what):
  image = _smooth(np.random.default_rng(0), 9, 11)
  buf = io.BytesIO()
  if what == "palette":
    Image.fromarray(image).convert("P").save(buf, format="PNG")
  elif what == "16bit":
    Image.fromarray(image[:, :, 0].astype(np.uint16) * 200).save(
        buf, format="PNG")
  else:
    # Pillow writes no interlaced PNG: mark the header Adam7.
    data = bytearray(encode_png(image))
    data[8 + 8 + 12] = 1
    buf.write(bytes(data))
  with pytest.raises(ValueError, match="shard-7#3: unsupported PNG"):
    png.decode(buf.getvalue(), "shard-7#3")


@pytest.mark.parametrize("shapes", [
    ((480, 640), (128, 128)), ((427, 640), (256, 256)),
    ((128, 128), (144, 144)), ((33, 47), (128, 128)),
    ((500, 375), (128, 128)), ((128, 128), (128, 64)),
    ((7, 300), (128, 128)), ((40, 50), (40, 50))],
    ids=lambda s: f"{s[0][0]}x{s[0][1]}-{s[1][0]}x{s[1][1]}")
def test_resize_matches_pillow(shapes):
  (h, w), (oh, ow) = shapes
  image = _smooth(np.random.default_rng(h * w), h, w)
  want = j_prep.resize_uint8(image, oh, ow)
  np.testing.assert_array_equal(resize.resize_uint8(image, oh, ow), want)
  np.testing.assert_array_equal(resize.resize_uint8_plain(image, oh, ow),
                                want)
  np.testing.assert_array_equal(preprocessing.resize_uint8(image, oh, ow),
                                want)
  fimage = image.astype(np.float32) / 255.0
  np.testing.assert_array_equal(preprocessing.resize_bilinear(fimage, oh, ow),
                                j_prep.resize_bilinear(fimage, oh, ow))


# ---------------------------------------------------------------------------
# Per-example preprocessing.
# ---------------------------------------------------------------------------


def _features(rng, image):
  return {
      "image": image,
      "caption/embedding": rng.standard_normal((5, 17, 24)).astype(
          np.float32),
      "caption/max_len": rng.integers(3, 18, (5,)).astype(np.float32),
      "caption/text": [f"caption {i}".encode() for i in range(5)],
  }


@pytest.mark.parametrize("case", [
    "shift-uint8", "shift-float", "zoom_crop-uint8", "zoom_crop-float",
    "shift-uint8-text", "zoom_crop-uint8-float_input"])
def test_preprocess_example_matches_jax(case):
  rng = np.random.default_rng(3)
  method, dtype = case.split("-")[:2]
  image = _smooth(rng, 45, 61)
  if case.endswith("float_input"):
    image = rng.uniform(0, 1, (38, 41, 3)).astype(np.float32)
  else:
    image = encode_png(image)
  features = _features(rng, image)
  kwargs = dict(image_size=32, z_dim=6, augment_method=method,
                image_uint8=dtype == "uint8",
                return_text=case.endswith("text"))
  got = preprocessing.preprocess_example(
      features, np.random.Generator(np.random.Philox(key=11)), **kwargs)
  want = j_prep.preprocess_example(
      features, np.random.Generator(np.random.Philox(key=11)), **kwargs)
  assert set(got) == set(want)
  for key in want:
    if key == "text":
      assert got[key] == want[key]
    else:
      assert got[key].dtype == want[key].dtype, key
      np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# TFRecord files.
# ---------------------------------------------------------------------------


def _examples(n, seed=0):
  rng = np.random.default_rng(seed)
  return [{
      "image": encode_png(_smooth(rng, 20 + i, 30)),
      "caption/embedding": rng.standard_normal(5 * 17 * 8).astype(
          np.float32),
      "caption/max_len": rng.integers(3, 18, (5,)).astype(np.int64),
      "caption/text": [b"a caption"] * 5,
  } for i in range(n)]


def _same_features(got, want):
  assert set(got) == set(want)
  for key, value in want.items():
    if isinstance(value, list):
      assert got[key] == value
    else:
      np.testing.assert_array_equal(got[key], value)


def test_records_each_package_reads_the_others(tmp_path):
  examples = _examples(5)
  ours, theirs = str(tmp_path / "ours.tfrecord"), str(tmp_path /
                                                      "theirs.tfrecord")
  with records.TFRecordWriter(ours) as w:
    for e in examples:
      w.write(records.build_example(e))
  with j_records.TFRecordWriter(theirs) as w:
    for e in examples:
      w.write(j_records.build_example(e))
  with open(ours, "rb") as a, open(theirs, "rb") as b:
    assert a.read() == b.read()
  # Each package builds the .idx of one file; the other reads it.
  j_file = j_records.TFRecordFile(ours, verify_crc=True)
  assert os.path.exists(ours + ".idx")
  file = records.TFRecordFile(theirs, verify_crc=True)
  assert os.path.exists(theirs + ".idx")
  ours_again = records.TFRecordFile(ours, verify_crc=True)
  theirs_again = j_records.TFRecordFile(theirs, verify_crc=True)
  np.testing.assert_array_equal(ours_again.offsets, j_file.offsets)
  np.testing.assert_array_equal(theirs_again.offsets, file.offsets)
  for i in range(len(examples)):
    _same_features(records.parse_example(j_file.read(i)),
                   j_records.parse_example(j_file.read(i)))
    _same_features(records.parse_example(file.read(i)),
                   j_records.parse_example(theirs_again.read(i)))
    assert ours_again.read(i) == theirs_again.read(i)


def test_crc32c_matches():
  rng = np.random.default_rng(0)
  assert records.crc32c(b"123456789") == 0xE3069283
  for n in (0, 1, 7, 8, 9, 63, 1000, 1 << 20):
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    want = j_records.crc32c(data)
    assert records.crc32c(data) == want
    if n <= 1000:
      assert records.crc32c_plain(data) == want
    assert records.masked_crc(data) == j_records.masked_crc(data)


def test_scan_offsets_truncated_shard(tmp_path):
  path = str(tmp_path / "cut.tfrecord")
  with records.TFRecordWriter(path) as w:
    for e in _examples(4):
      w.write(records.build_example(e))
  whole = records.scan_offsets(path)
  assert len(whole) == 4
  with open(path, "r+b") as f:
    f.truncate(os.path.getsize(path) - 5)
  for got in (records.scan_offsets(path), records.scan_offsets_plain(path)):
    np.testing.assert_array_equal(got, j_records._scan_offsets(path))
    np.testing.assert_array_equal(got, whole[:3])


# ---------------------------------------------------------------------------
# Loaders.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
  """16 small train shards and 2 validation shards in the reference
  schema, images of several sizes, Pillow's and five-filter PNGs."""
  root = tmp_path_factory.mktemp("coco")
  rng = np.random.default_rng(5)
  for split, shards, per in (("train", 16, 2), ("validation", 2, 4)):
    for s in range(shards):
      path = root / f"coco2014_{split}.tfrecord-{s:05d}-of-{shards:05d}"
      with records.TFRecordWriter(str(path)) as w:
        for i in range(per):
          image = _smooth(rng, int(rng.integers(30, 70)),
                          int(rng.integers(30, 70)))
          data = encode_png(image) if i % 2 else _pillow_png(image)
          w.write(records.build_example({
              "image": data,
              "image/filename": [f"{split}_{s}_{i}.png".encode()],
              "caption/embedding": rng.standard_normal(
                  5 * 17 * 768).astype(np.float32),
              "caption/max_len": rng.integers(3, 18, (5,)).astype(np.int64),
              "caption/text": [f"caption {s} {i} {c}".encode()
                               for c in range(5)],
          }))
  return str(root)


def _loader_configs(source, data_dir, workers=0, shuffle=False):
  j_config, config = j_coco_xmc.get_test_config(), coco_xmc.get_test_config()
  for c in (j_config, config):
    c.data_source = source
    c.data_dir = data_dir
    c.grain_worker_count = workers
    c.train_shuffle = shuffle
  return j_config, config


def _assert_batches_equal(got, want):
  assert set(got) == set(want)
  for key, value in want.items():
    assert got[key].dtype == value.dtype, key
    np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("source,workers,shuffle", [
    ("tfrecord", 0, False), ("tfrecord", 2, False), ("synthetic", 0, False),
    ("tfrecord", 0, True), ("synthetic", 2, True)])
def test_create_datasets_matches_jax(source, workers, shuffle, data_dir):
  """The first 3 train super-batches and eval batches, bit for bit."""
  j_config, config = _loader_configs(source, data_dir, workers, shuffle)
  j_train, j_eval, j_n = j_pipeline.create_datasets(j_config, seed=7)
  train, evaluation, n = pipeline.create_datasets(config, seed=7)
  assert n == j_n == (32 if source == "tfrecord" else 64)
  for ours, theirs in ((train, j_train), (evaluation, j_eval)):
    it, j_it = iter(ours), iter(theirs)
    try:
      for _ in range(3):
        _assert_batches_equal(next(it), next(j_it))
    finally:
      it.close()


@pytest.mark.parametrize("max_index", [0, 1, 9, 31, 1000, 65536, 82782,
                                       2**20 + 3, 2**31 + 7])
def test_index_shuffle_matches_grain(max_index):
  """grain's C++ shuffle, which its ``ShuffleMapDataset`` calls per
  epoch with the seed ``(seed + epoch) % 2**32`` and 4 rounds."""
  from grain._src.python.experimental.index_shuffle.python import (
      index_shuffle_module as grain_shuffle,
  )
  rng = np.random.default_rng(max_index)
  for seed in (0, 3, 2**32 - 1, int(rng.integers(2**32))):
    index = rng.integers(0, max_index + 1, 8)
    want = [grain_shuffle.index_shuffle(int(i), max_index=max_index,
                                        seed=seed, rounds=4) for i in index]
    assert pipeline.index_shuffle(index, max_index, seed).tolist() == want


@pytest.mark.parametrize("image_uint8", [True, False])
def test_template_batch_matches_jax(image_uint8):
  j_config, config = _loader_configs("synthetic", "")
  j_config.image_uint8 = config.image_uint8 = image_uint8
  for n in (None, 6):
    want = j_pipeline.template_batch(j_config, n)
    _assert_batches_equal(pipeline.template_batch(config, n), want)


def test_train_shuffle_visits_every_record_once_an_epoch(data_dir):
  _, config = _loader_configs("tfrecord", data_dir, shuffle=True)
  train, _, n = pipeline.create_datasets(config, seed=3)
  again, _, _ = pipeline.create_datasets(config, seed=3)
  other, _, _ = pipeline.create_datasets(config, seed=4)
  orders = []
  for epoch in range(3):
    keys = [train.record_key(epoch * n + i) for i in range(n)]
    assert sorted(keys) == list(range(n))
    assert keys == [again.record_key(epoch * n + i) for i in range(n)]
    orders.append(keys)
  assert orders[0] != orders[1] != orders[2]
  assert orders[0] != [other.record_key(i) for i in range(n)]
  # Each batch holds its positions' records.
  batch = train.batch(2)
  want = np.stack([train.example(p)["embedding"]
                   for p in train.positions(2)])
  np.testing.assert_array_equal(batch["embedding"], want)


def test_loader_resumes_exactly(data_dir):
  _, config = _loader_configs("tfrecord", data_dir, shuffle=True)
  train, _, _ = pipeline.create_datasets(config, seed=1)
  it = iter(train)
  for _ in range(3):
    next(it)
  state = it.get_state()
  assert state["position"] == 3
  want = [next(it) for _ in range(2)]
  resumed = iter(pipeline.create_datasets(config, seed=1)[0])
  resumed.set_state(state)
  for w in want:
    _assert_batches_equal(next(resumed), w)
  with pytest.raises(ValueError, match="loader"):
    iter(pipeline.create_datasets(config, seed=2)[0]).set_state(state)


@pytest.mark.parametrize("size", [1, 3])
def test_prefetcher_resumes_exactly(size, data_dir):
  """The state after n batches is the position of the n-th, however many
  the prefetcher holds ahead; a prefetcher set to it gives the batches
  that follow."""
  _, config = _loader_configs("tfrecord", data_dir)
  train = pipeline.create_datasets(config, seed=2)[0]
  prefetcher = DevicePrefetcher(iter(train), "cpu", size=size)
  try:
    for _ in range(4):
      next(prefetcher)
    state = prefetcher.get_state()
    want = [next(prefetcher) for _ in range(2)]
  finally:
    prefetcher.close()
  assert state["position"] == 4
  resumed = DevicePrefetcher(iter(train), "cpu", size=size)
  try:
    resumed.set_state(state)
    for w in want:
      got = next(resumed)
      assert set(got) == set(w)
      for key in w:
        torch.testing.assert_close(got[key], w[key], rtol=0, atol=0)
    assert resumed.get_state()["position"] == 6
  finally:
    resumed.close()
  batch = train.batch(4)
  for key, value in want[0].items():
    np.testing.assert_array_equal(value.numpy(), batch[key])


def test_train_step_k_takes_the_jax_loaders_super_batch_k(
    data_dir, tmp_path, monkeypatch):
  """The JAX loop spends super-batch 0 on initializing its models and
  trains step k on super-batch k; so does the port's `train.train`, on a
  fresh run (steps 1 and 2) and after a resume (step 3)."""
  j_config, config = _loader_configs("tfrecord", data_dir, shuffle=True)
  seen = []

  def step(state, batch, config, additional_data):
    seen.append({k: v.numpy().copy() for k, v in batch.items()})
    state.step += 1
    return state, {"d_loss": torch.zeros(())}

  monkeypatch.setattr(train_lib, "train_step", step)
  workdir = str(tmp_path / "work")
  for steps in (2, 3):
    config.num_train_steps = steps
    train_lib.train(config, workdir, "cpu")
  j_it = iter(j_pipeline.create_datasets(j_config, seed=j_config.seed)[0])
  want = [next(j_it) for _ in range(4)][1:]
  assert len(seen) == 3
  for got, theirs in zip(seen, want):
    _assert_batches_equal(got, {k: theirs[k] for k in got})


# ---------------------------------------------------------------------------
# The slice as a whole.
# ---------------------------------------------------------------------------

OVERRIDES = dict(dtype="float32", scale_fused_convs=True,
                 upconv_method="dilated")
LOSSES = ("d_loss", "g_loss", "c_loss_d", "c_loss_g", "c_loss_g_pretrained")


def test_first_record_super_batch_through_one_step_matches_jax(data_dir):
  """The first train super-batch of the records from each package's
  loader (bit-identical) through one outer step of each package, from
  the same state (the JAX initialization, bridged)."""
  j_config, config = _loader_configs("tfrecord", data_dir)
  for c in (j_config, config):
    c.update(OVERRIDES)
  j_batch = next(iter(j_pipeline.create_datasets(j_config, seed=0)[0]))
  it = iter(pipeline.create_datasets(config, seed=0)[0])
  batch = next(it)
  it.close()
  _assert_batches_equal(batch, j_batch)

  init_batch = j_split(j_batch, j_config.d_step_per_g_step)[0]
  gen, disc, j_st = j_state(j_config, jax.random.PRNGKey(0), init_batch)
  s0 = jax.device_get(j_st)
  state = create_train_state(config, "cpu", seed=0)
  bridge.load_jax_variables(state.generator, {
      "params": s0.g_params, **s0.generator_state})
  bridge.load_jax_variables(state.discriminator, {
      "params": s0.d_params, **s0.discriminator_state})
  for opt, module, opt_state in ((state.g_opt, state.generator,
                                  s0.g_opt_state),
                                 (state.d_opt, state.discriminator,
                                  s0.d_opt_state)):
    adam = opt_state[0]
    bridge.load_adam_state(opt, module, adam.mu, adam.nu, int(adam.count))
  state.ema_params = bridge.tree_to_torch(s0.ema_params)

  step = jax.jit(functools.partial(
      j_step, generator=gen, discriminator=disc, config=j_config,
      additional_data={}))
  _, j_metrics = step(jax.random.PRNGKey(1), j_st, j_batch)
  _, metrics = train_step(state, bridge.to_tensors(batch), config, {})
  for key in LOSSES:
    want = float(j_metrics[key])
    got = float(metrics[key])
    assert abs(got - want) <= 1e-4 * max(abs(want), 1e-6), (key, got, want)

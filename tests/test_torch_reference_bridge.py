"""The port's loader of reference checkpoints (`utils/reference_bridge.py`)
against the JAX package's (``utils/reference_bridge.py``).

A reference-schema train state is built from the JAX package's own
reference-layout G (plain, and spectral) and D at the test config (32
px, width 16, float32): ``flax.optim`` Adam slots (random, so that their
split shows), ``generator_state``, ``discriminator_state`` and EMA
weights that differ from G's.  The test serializes it with
``flax.serialization.msgpack_serialize``, as the reference's
``clu.checkpoint`` does.

* The port's msgpack decoder, which imports neither flax nor msgpack,
  reads it to the same arrays as ``flax.serialization.msgpack_restore``,
  with leaves of every kind flax writes: bfloat16, float16 and integer
  arrays, a numpy scalar, a complex number, Python scalars, strings, a
  list, and an array that flax chunks when ``MAX_CHUNK_SIZE`` is patched
  small.  Arrays bit for bit.
* `convert_reference_train_state` fills the port's fused and
  reference-layout states; the port's EMA sample equals the JAX
  package's ``convert_reference_train_state`` + ``generate_batch`` within
  ``tests/test_torch_models.py``'s 1e-4 relative and 1e-5 absolute (the
  two packages' convs sum in other orders), and the Adam slots (split for
  the fused G), the counts, the step, the running averages and both
  networks' ``u0`` land bit for bit.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu.configs import coco_xmc as j_coco_xmc
from xmcgan_image_generation_tpu.engine import create_train_state as j_state
from xmcgan_image_generation_tpu.engine.sampling import (
    generate_batch as j_generate_batch,
)
from xmcgan_image_generation_tpu.utils import reference_bridge as j_bridge
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.engine.sampling import generate_batch
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.utils import bridge
from xmcgan_image_generation_tpu_torch.utils import reference_bridge

torch.set_num_threads(1)

LAYOUTS = {
    "fused": dict(fused_spatial_cond=True, g_spectral_norm=False),
    "reference": dict(fused_spatial_cond=False, g_spectral_norm=False),
    "spectral": dict(fused_spatial_cond=False, g_spectral_norm=True),
}


def _configs(layout):
  out = []
  for config in (j_coco_xmc.get_test_config(), coco_xmc.get_test_config()):
    config.dtype = "float32"
    for k, v in LAYOUTS[layout].items():
      setattr(config, k, v)
    out.append(config)
  return tuple(out)


def _batch(n=3, seed=0):
  rng = np.random.default_rng(seed)
  return {
      "image": rng.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8),
      "embedding": rng.standard_normal((n, 17, 768)).astype(np.float32),
      "sentence_embedding": rng.standard_normal((n, 768)).astype(np.float32),
      "max_len": rng.integers(3, 18, (n, 1)).astype(np.float32),
      "z": rng.standard_normal((n, 8)).astype(np.float32),
  }


def _tree(tree):
  return jax.tree_util.tree_map(np.asarray, jax.device_get(dict(tree)))


def _reference_state(layout):
  """A reference-schema train state from the JAX package's
  reference-layout G of ``layout`` and its D."""
  j_config, _ = _configs(layout)
  batch = _batch(2)
  _, _, state = j_state(j_config, jax.random.PRNGKey(0), batch)
  rng = np.random.default_rng(3)

  def adam_slots(params):
    return jax.tree_util.tree_map(
        lambda p: {"grad_ema": rng.standard_normal(p.shape).astype(
            np.float32),
                   "grad_sq_ema": rng.uniform(0.1, 1.0, p.shape).astype(
                       np.float32)},
        params, is_leaf=lambda x: not isinstance(x, dict))

  g_params, d_params = _tree(state.g_params), _tree(state.d_params)
  generator_state = _tree(state.generator_state)
  generator_state["batch_stats"] = jax.tree_util.tree_map(
      lambda x: (x + rng.uniform(0.1, 0.5, x.shape)).astype(np.float32),
      generator_state["batch_stats"])
  return {
      "step": 123,
      "g_optimizer": {"state": {"step": 123,
                                "param_states": adam_slots(g_params)},
                      "target": g_params},
      "d_optimizer": {"state": {"step": 246,
                                "param_states": adam_slots(d_params)},
                      "target": d_params},
      "generator_state": generator_state,
      "discriminator_state": _tree(state.discriminator_state),
      "ema_params": jax.tree_util.tree_map(
          lambda p: (p + 0.02 * rng.standard_normal(p.shape)).astype(
              np.float32), g_params),
  }


@pytest.fixture(scope="module", params=["reference", "spectral"])
def checkpoint(request, tmp_path_factory):
  raw = _reference_state(request.param)
  path = tmp_path_factory.mktemp(request.param) / "ckpt-123"
  path.write_bytes(flax.serialization.msgpack_serialize(raw))
  return dict(layout=request.param, raw=raw, path=str(path))


def _same(got, want, where="root"):
  """``got`` (the port's decoding) holds ``want`` (flax's)."""
  if isinstance(want, dict):
    assert isinstance(got, dict) and set(got) == set(want), where
    for k in want:
      _same(got[k], want[k], f"{where}/{k}")
  elif isinstance(want, list):
    assert isinstance(got, list) and len(got) == len(want), where
    for i, (g, w) in enumerate(zip(got, want)):
      _same(g, w, f"{where}/{i}")
  elif isinstance(want, np.ndarray):
    assert isinstance(got, torch.Tensor), where
    assert str(got.dtype).replace("torch.", "") == want.dtype.name, where
    assert tuple(got.shape) == want.shape, where
    if want.dtype.name == "bfloat16":
      got, want = got.float().numpy(), want.astype(np.float32)
    np.testing.assert_array_equal(got.numpy() if isinstance(
        got, torch.Tensor) else got, want, err_msg=where)
  else:
    assert type(got) is type(want.item() if isinstance(want, np.generic)
                             else want), where
    assert got == want, where


def test_decoder_reads_the_checkpoint_as_flax_does(checkpoint):
  data = open(checkpoint["path"], "rb").read()
  want = flax.serialization.msgpack_restore(data)
  got = reference_bridge.load_reference_msgpack(checkpoint["path"])
  _same(got, want)
  assert got["step"] == 123


def test_decoder_reads_every_leaf_kind(monkeypatch):
  rng = np.random.default_rng(4)
  tree = {
      "bf16": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
      "f16": rng.standard_normal((4,)).astype(np.float16),
      "f64": rng.standard_normal((2, 2)),
      "i8": np.arange(-4, 4, dtype=np.int8),
      "u8": np.arange(250, 256, dtype=np.uint8),
      "i64": np.array([-2**40, 2**40], np.int64),
      "bool": np.array([True, False]),
      "empty": np.zeros((0, 3), np.float32),
      "scalar": np.float32(1.5),
      "int_scalar": np.int32(-7),
      "complex": 1.0 + 2.0j,
      "ints": [0, 127, 128, 255, 256, 65536, 2**32, -1, -32, -33, -129,
               -2**31 - 1],
      "floats": [0.25, -1e300],
      "none": None,
      "flags": [True, False],
      "text": "a caption" * 40,
      "nested": {"deep": {"kernel": rng.standard_normal((2, 3)).astype(
          np.float32)}},
  }
  # A long map (map 16), a long list (array 16) and a chunked array.
  tree["many"] = {f"k{i}": i for i in range(20)}
  tree["long"] = list(range(20))
  monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
  tree["chunked"] = rng.standard_normal((7, 9)).astype(np.float32)
  data = flax.serialization.msgpack_serialize(tree)
  monkeypatch.undo()
  assert data.count(b"__msgpack_chunked_array__") >= 1
  want = flax.serialization.msgpack_restore(data)
  got = reference_bridge.msgpack_restore(data)
  _same(got, want)
  assert got["bf16"].dtype == torch.bfloat16
  assert got["chunked"].shape == (7, 9)


def test_decoder_rejects_what_flax_does_not_write():
  with pytest.raises(ValueError, match="extension type 5"):
    reference_bridge.msgpack_restore(b"\xd4\x05\x00")
  with pytest.raises(ValueError, match="truncated"):
    reference_bridge.msgpack_restore(b"\x92\x01")
  with pytest.raises(ValueError, match="after"):
    reference_bridge.msgpack_restore(b"\x01\x02")


def test_split_modulation_kernels_is_jax_s(checkpoint):
  params = checkpoint["raw"]["g_optimizer"]["target"]
  want = bridge.flatten(j_bridge.split_modulation_kernels(params), sep="/")
  got = bridge.flatten(reference_bridge.split_modulation_kernels(params),
                       sep="/")
  assert set(got) == set(want)
  for k, v in want.items():
    np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def _targets(layout):
  """The layouts a checkpoint of ``layout``'s G converts into."""
  return ["fused", "reference"] if layout == "reference" else ["spectral"]


def test_convert_into_each_layout(checkpoint):
  raw = reference_bridge.load_reference_msgpack(checkpoint["path"])
  flax_raw = j_bridge.load_reference_msgpack(checkpoint["path"])
  batch = _batch(3, seed=1)
  for target in _targets(checkpoint["layout"]):
    fused = target == "fused"
    j_config, config = _configs(target)
    generator, _, template = j_state(j_config, jax.random.PRNGKey(9),
                                     _batch(2))
    j_converted = j_bridge.convert_reference_train_state(
        flax_raw, template, fused_spatial_cond=fused)
    want = j_generate_batch(jax.random.PRNGKey(0), j_converted, batch,
                            generator=generator, config=j_config)

    state = create_train_state(config, "cpu", seed=5)
    assert state.generator.fused == fused
    got_state = reference_bridge.convert_reference_train_state(
        raw, state, fused_spatial_cond=fused)
    assert got_state is state and state.step == 123
    out = generate_batch(state, bridge.to_tensors(batch), config)
    for key in ("ema_generated_image", "generated_image"):
      np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]),
                                 rtol=1e-4, atol=1e-5, err_msg=key)

    # The Adam slots, the counts and the collections, bit for bit.
    j_new = jax.device_get(j_converted)
    for opt, module, opt_state, count in (
        (state.g_opt, state.generator, j_new.g_opt_state, 123),
        (state.d_opt, state.discriminator, j_new.d_opt_state, 246)):
      mu, nu, got_count = bridge.adam_state_to_jax(opt, module)
      assert got_count == count == int(opt_state[0].count)
      for got, want_tree in ((mu, opt_state[0].mu), (nu, opt_state[0].nu)):
        want_flat = bridge.flatten(want_tree)
        got_flat = bridge.flatten(got)
        assert set(got_flat) == set(want_flat)
        for k, v in want_flat.items():
          np.testing.assert_array_equal(got_flat[k], np.asarray(v),
                                        err_msg=k)
    for module, variables in (
        (state.generator, {"params": j_new.g_params,
                           **j_new.generator_state}),
        (state.discriminator, {"params": j_new.d_params,
                               **j_new.discriminator_state})):
      want_sd = bridge.state_dict_from_jax(jax.device_get(variables))
      got_sd = module.state_dict()
      assert set(got_sd) == set(want_sd)
      for k, v in want_sd.items():
        torch.testing.assert_close(got_sd[k], v, rtol=0, atol=0, msg=k)
    want_ema = bridge.tree_to_torch(j_new.ema_params)
    assert set(state.ema_params) == set(want_ema)
    for k, v in want_ema.items():
      torch.testing.assert_close(state.ema_params[k], v, rtol=0, atol=0)


def test_convert_names_a_layout_mismatch(checkpoint):
  raw = reference_bridge.load_reference_msgpack(checkpoint["path"])
  _, config = _configs("reference" if checkpoint["layout"] == "reference"
                       else "spectral")
  state = create_train_state(config, "cpu", seed=5)
  with pytest.raises(ValueError, match="fused.*reference"):
    reference_bridge.convert_reference_train_state(raw, state,
                                                   fused_spatial_cond=True)

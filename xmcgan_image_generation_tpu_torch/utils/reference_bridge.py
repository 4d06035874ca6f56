"""Checkpoints of the reference implementation, loaded into the port (the
JAX package's ``utils/reference_bridge.py``).

The reference writes its train state as one msgpack blob with
``flax.serialization`` (``clu.checkpoint``).  `load_reference_msgpack`
reads that format with a small decoder of its own, since the port needs
neither flax nor the ``msgpack`` package:

* msgpack maps, arrays, strings, binaries, integers, floats, nil and
  booleans (maps become dicts, arrays lists);
* flax's extension types: 1, an array as the msgpack triple ``(shape,
  dtype name, C-order bytes)``, read into a tensor (``bfloat16`` as
  ``torch.bfloat16``); 2, a complex number as ``(real, imag)``; 3, a
  numpy scalar, stored as a 0-d array and read into a Python scalar;
* flax's chunked arrays (``{"__msgpack_chunked_array__": True, "shape":
  {"0": ...}, "chunks": {"0": ...}}``, which it writes for leaves above
  ``MAX_CHUNK_SIZE`` bytes) are joined into one tensor.

`convert_reference_train_state` then fills the port's `TrainState` in
place: parameters, EMA, the running averages and both networks' ``u0``
verbatim (the module names are flax's, `utils.bridge` maps the layouts),
and ``flax.optim`` Adam's ``grad_ema`` / ``grad_sq_ema`` and step as
``torch.optim.Adam``'s ``exp_avg`` / ``exp_avg_sq`` and step.  The
reference's G has the reference layout; the port's fused G is reached by
splitting each ``LocalConditionalBatchNorm`` 1x1 kernel into its
region-context and global parts (`split_modulation_kernels`, exact), its
Adam slots included.

This module imports no JAX, flax or msgpack.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from xmcgan_image_generation_tpu_torch.engine.state import TrainState
from xmcgan_image_generation_tpu_torch.utils import bridge

REGION_DIM = 768  # BERT feature width of the region-context map.

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
  """A msgpack decoder over one buffer (the subset flax writes, with every
  basic type)."""

  def __init__(self, data: bytes, ext_hook: Callable[[int, bytes], Any]):
    self.data = memoryview(data)
    self.pos = 0
    self.ext_hook = ext_hook

  def take(self, n: int) -> memoryview:
    if self.pos + n > len(self.data):
      raise ValueError("truncated msgpack data")
    out = self.data[self.pos:self.pos + n]
    self.pos += n
    return out

  def unpack(self, fmt: str):
    return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

  def read(self) -> Any:
    b = self.unpack(">B")
    if b <= 0x7f:
      return b
    if b >= 0xe0:
      return b - 0x100
    if 0x80 <= b <= 0x8f:
      return self._map(b & 0x0f)
    if 0x90 <= b <= 0x9f:
      return self._array(b & 0x0f)
    if 0xa0 <= b <= 0xbf:
      return self._str(b & 0x1f)
    fixed = {0xc0: None, 0xc2: False, 0xc3: True}
    if b in fixed:
      return fixed[b]
    numbers = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
               0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
    if b in numbers:
      return self.unpack(numbers[b])
    sizes = {0: ">B", 1: ">H", 2: ">I"}
    if 0xc4 <= b <= 0xc6:                       # bin 8/16/32
      return bytes(self.take(self.unpack(sizes[b - 0xc4])))
    if 0xd9 <= b <= 0xdb:                       # str 8/16/32
      return self._str(self.unpack(sizes[b - 0xd9]))
    if b in (0xdc, 0xdd):                       # array 16/32
      return self._array(self.unpack(sizes[b - 0xdb]))
    if b in (0xde, 0xdf):                       # map 16/32
      return self._map(self.unpack(sizes[b - 0xdd]))
    if 0xc7 <= b <= 0xc9:                       # ext 8/16/32
      n = self.unpack(sizes[b - 0xc7])
      return self._ext(n)
    if 0xd4 <= b <= 0xd8:                       # fixext 1/2/4/8/16
      return self._ext(1 << (b - 0xd4))
    raise ValueError(f"unknown msgpack type byte 0x{b:02x} at {self.pos - 1}")

  def _str(self, n: int) -> str:
    return bytes(self.take(n)).decode("utf-8")

  def _array(self, n: int) -> list:
    return [self.read() for _ in range(n)]

  def _map(self, n: int) -> dict:
    out = {}
    for _ in range(n):
      key = self.read()
      out[key] = self.read()
    return out

  def _ext(self, n: int) -> Any:
    code = self.unpack(">b")
    return self.ext_hook(code, bytes(self.take(n)))


def _unpackb(data: bytes, ext_hook=None) -> Any:
  """One msgpack object from ``data`` (all of it)."""

  def no_ext(code, _):
    raise ValueError(f"msgpack extension type {code} is not handled")

  reader = _Reader(data, ext_hook or no_ext)
  out = reader.read()
  if reader.pos != len(reader.data):
    raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                     f"msgpack object")
  return out


def _tensor_from_bytes(data: bytes) -> torch.Tensor:
  """flax's array payload ``(shape, dtype name, C-order bytes)``."""
  shape, name, buffer = _unpackb(data)
  name = name.decode() if isinstance(name, bytes) else name
  if name == "bfloat16":
    flat = torch.from_numpy(np.frombuffer(buffer, np.uint16).copy())
    flat = flat.view(torch.bfloat16)
  else:
    flat = torch.from_numpy(np.frombuffer(buffer, np.dtype(name)).copy())
  return flat.reshape(tuple(shape))


def _flax_ext(code: int, data: bytes) -> Any:
  if code == _EXT_NDARRAY:
    return _tensor_from_bytes(data)
  if code == _EXT_COMPLEX:
    real, imag = _unpackb(data)
    return complex(real, imag)
  if code == _EXT_NPSCALAR:
    return _tensor_from_bytes(data).item()
  raise ValueError(f"msgpack extension type {code} is not one of flax's")


def _unchunk(tree: Any) -> Any:
  """Joins flax's chunked arrays, anywhere in the tree."""
  if not isinstance(tree, dict):
    return tree
  if tree.get(_CHUNKED):
    shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
    chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
    return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
  return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
  """``flax.serialization.msgpack_restore``: nested dicts (and lists) with
  tensor and Python-scalar leaves."""
  return _unchunk(_unpackb(data, _flax_ext))


def load_reference_msgpack(path: str) -> Dict[str, Any]:
  """Reads a flax-serialized reference checkpoint into nested dicts."""
  with open(path, "rb") as f:
    return msgpack_restore(f.read())


def _flatten(tree: Mapping[str, Any]) -> Dict[str, Any]:
  return bridge.flatten(tree, sep="/")


def _unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
  return bridge.unflatten(flat, sep="/")


def split_modulation_kernels(naive_params: Mapping[str, Any],
                             region_dim: int = REGION_DIM
                             ) -> Dict[str, Any]:
  """Reference-layout generator parameters (flax layout, HWIO kernels)
  -> the fused-modulation layout.

  Splits each ``LocalConditionalBatchNorm`` 1x1 kernel ``[1, 1,
  region_dim + global_dim, C]`` into the fused pair (the context conv
  ``[1, 1, region_dim, C]`` and the global dense ``[global_dim, C]`` with
  the conv's bias) and renames the spatial blocks.  Exact for plain
  convs (``ops.normalization.FusedSpatialModulation``).  Leaves may be
  tensors or numpy arrays.
  """
  names = {"Conv_0": ("gamma_ctx", "gamma_global"),
           "Conv_1": ("beta_ctx", "beta_global")}
  mapped: Dict[str, Any] = {}
  for path, value in _flatten(naive_params).items():
    p = path.replace("GenSpatialBlock_", "GenSpatialBlockFused_")
    if "LocalConditionalBatchNorm" not in p:
      mapped[p] = value
      continue
    base, tail = p.split("LocalConditionalBatchNorm")
    idx, rest = tail.split("/", 1)
    mod = f"{base}FusedSpatialModulation{idx}"
    conv, _, leaf = rest.partition("/")
    if conv not in names:
      mapped[f"{mod}/{rest}"] = value
      continue
    ctx, glob = names[conv]
    if leaf == "kernel":
      mapped[f"{mod}/{ctx}/kernel"] = value[:, :, :region_dim, :]
      mapped[f"{mod}/{glob}/kernel"] = value[0, 0, region_dim:, :]
    elif leaf == "bias":
      mapped[f"{mod}/{glob}/bias"] = value
  return _unflatten(mapped)


def rename_state_for_fused(state_tree: Mapping[str, Any]) -> Dict[str, Any]:
  """Mutable-collection paths of the reference layout -> the fused one."""
  return _unflatten({
      k.replace("GenSpatialBlock_", "GenSpatialBlockFused_").replace(
          "LocalConditionalBatchNorm", "FusedSpatialModulation"): v
      for k, v in _flatten(state_tree).items()})


def _numpy(tree: Any) -> Any:
  """Tensor leaves as numpy arrays (``bfloat16`` widened to float32)."""
  if isinstance(tree, Mapping):
    return {k: _numpy(v) for k, v in tree.items()}
  if isinstance(tree, torch.Tensor):
    if tree.dtype == torch.bfloat16:
      tree = tree.float()
    return tree.numpy()
  return tree


def _adam_slots(param_states: Mapping[str, Any], slot: str) -> Dict[str, Any]:
  """``flax.optim`` per-parameter state dicts -> one tree of ``slot``."""
  if set(param_states) >= {"grad_ema", "grad_sq_ema"}:
    return param_states[slot]
  out = {}
  for k, v in param_states.items():
    if not isinstance(v, Mapping):
      raise TypeError(f"unexpected flax.optim param_states leaf at {k!r}: "
                      f"{type(v).__name__}")
    out[k] = _adam_slots(v, slot)
  return out


def convert_reference_train_state(raw: Mapping[str, Any], state: TrainState,
                                  fused_spatial_cond: bool = True
                                  ) -> TrainState:
  """Fills ``state`` (from ``create_train_state`` of the matching
  configuration) with the reference train state ``raw`` and returns it.

  ``raw`` is the msgpack structure of the reference's checkpointed unit:
  ``step``, ``g_optimizer`` / ``d_optimizer`` (``flax.optim`` ``{state:
  {step, param_states}, target}``), ``generator_state``,
  ``discriminator_state`` and ``ema_params``.  ``fused_spatial_cond``
  names the layout of ``state``'s G: the fused one (the reference's G,
  its EMA and G's Adam slots are split into it) or the reference one
  (verbatim).  Raises if it is not the layout of ``state``'s G.
  """
  g_net, d_net = state.generator, state.discriminator
  layout = {True: "fused", False: "reference"}
  if bool(fused_spatial_cond) != bool(g_net.fused):
    raise ValueError(
        f"fused_spatial_cond={fused_spatial_cond} asks for the "
        f"{layout[bool(fused_spatial_cond)]} layout, but the state's "
        f"generator has the {layout[bool(g_net.fused)]} layout")
  raw = _numpy(raw)
  g_opt, d_opt = raw["g_optimizer"], raw["d_optimizer"]
  g_params = g_opt["target"]
  ema_params = raw["ema_params"]
  generator_state = dict(raw.get("generator_state") or {})
  discriminator_state = dict(raw.get("discriminator_state") or {})
  g_slots = [_adam_slots(g_opt["state"]["param_states"], slot)
             for slot in ("grad_ema", "grad_sq_ema")]
  d_slots = [_adam_slots(d_opt["state"]["param_states"], slot)
             for slot in ("grad_ema", "grad_sq_ema")]
  if fused_spatial_cond:
    g_params = split_modulation_kernels(g_params)
    ema_params = split_modulation_kernels(ema_params)
    generator_state = {k: rename_state_for_fused(v)
                       for k, v in generator_state.items()}
    # The optimizer slots follow the same parameter-tree transform.
    g_slots = [split_modulation_kernels(t) for t in g_slots]

  bridge.load_jax_variables(g_net, {"params": g_params, **generator_state})
  bridge.load_jax_variables(d_net, {"params": d_opt["target"],
                                    **discriminator_state})
  ema = bridge.tree_to_torch(ema_params)
  own = dict(g_net.named_parameters())
  if set(ema) != set(own):
    raise ValueError(f"the EMA does not fit the generator: "
                     f"{sorted(set(ema) ^ set(own))[:5]}")
  state.ema_params = {name: ema[name].to(p.device, p.dtype)
                      for name, p in own.items()}
  bridge.load_adam_state(state.g_opt, g_net, *g_slots,
                         int(g_opt["state"]["step"]))
  bridge.load_adam_state(state.d_opt, d_net, *d_slots,
                         int(d_opt["state"]["step"]))
  state.step = int(raw["step"])
  return state

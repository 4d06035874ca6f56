"""Serving export: the trained generator as a standalone ``torch.export``
artifact (the JAX package's ``utils/serving.py``).

`export_generator` traces G in eval mode, with its normal or EMA weights
and its BatchNorm running averages, into an ``ExportedProgram`` with the
pure signature::

    (sentence_embedding [b, 768], embedding [b, 17, 768],
     max_len [b, 1], z [b, z_dim]) -> float32 images [b, S, S, 3] in [0, 1]

``b`` is static, or symbolic (``batch_size=None``) so that one artifact
serves any batch size.  ``torch.export.save`` writes it (``.pt2``), and a
consumer runs it with ``torch.export.load(path).module()(*inputs)`` with
nothing but ``torch``: no port, no checkpoint, no configuration.  The
program is traced on the device the caller names (``cuda`` by default)
and its weights live there; `load_exported` moves it to another device
(JAX's multi-platform lowering: a CPU-traced artifact serves on the
card).

``export_generator(..., devices=[d0, .., dN-1])`` is the JAX package's
``export_generator(mesh=...)``: one artifact whose single call serves a
static batch B split over N devices, with the weights replicated.  It
holds one program of B / N rows, its weights once, and records N and B
in the file (`SHARDING_FILE`); ``load_exported(path, devices=...)`` puts
a copy of the program on each of any N devices and returns a
`ShardedGenerator`, which splits each input along the batch, runs the
chunks and concatenates the images.  No process group is involved, as
with JAX's one-controller call; a consumer with nothing but ``torch``
does the same split by hand.

`export_from_workdir` (``--mode=export``) runs in every process of a
``torchrun`` job: process 0 restores the checkpoint and writes the
artifacts once, the others wait for it and return the same paths.  (The
JAX package lets every process write the same files.)
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch
from torch import nn

from xmcgan_image_generation_tpu_torch.models import xmc_net
from xmcgan_image_generation_tpu_torch.ops.spectral_norm import (
    Conv,
    Dense,
    power_iteration_normalize,
    precomputed_kernels,
)
from xmcgan_image_generation_tpu_torch.utils import fileio

Tensor = torch.Tensor

#: Text conditioning constants (reference libml/dataset_constants.py:15-20).
BERT_DIM = 768
COCO_MAX_TEXT_LENGTH = 17

INPUTS = ("sentence_embedding", "embedding", "max_len", "z")

#: A sharded artifact's record of its placement, one of the ``.pt2``'s
#: ``extra_files``: the mesh axis, its device count N and the global batch.
SHARDING_FILE = "sharding.json"
MESH_AXIS = "data"

#: The device types an artifact traced on a device type was checked to
#: serve on (``chip_smoke.py`` phase 7b): a CPU-traced program moved to
#: the card serves there; a card-traced one does not load in a process
#: that sees no card.
SERVES_ON = {"cpu": ("cpu", "cuda"), "cuda": ("cuda",)}


def load_config_module(spec: str):
  """``<module>[:variant]`` of the port's ``configs`` -> its config."""
  module, _, variant = spec.partition(":")
  mod = importlib.import_module(
      f"xmcgan_image_generation_tpu_torch.configs.{module}")
  return mod.get_config(variant) if variant else mod.get_config()


def check_device(device) -> torch.device:
  """``device`` as a ``torch.device``; raises for ``cuda`` without a card
  (there is no quiet fall-back to the CPU)."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device; pass device='cpu' (--device=cpu) "
                       "to run on the CPU")
  return device


def make_init_batch(config, batch: int = 2, device=None) -> Dict[str, Tensor]:
  """A batch of the serving inputs' shapes (zeros; ``max_len`` full)."""
  return {
      "sentence_embedding": torch.zeros((batch, BERT_DIM), device=device),
      "embedding": torch.zeros((batch, COCO_MAX_TEXT_LENGTH, BERT_DIM),
                               device=device),
      "max_len": torch.full((batch, 1), float(COCO_MAX_TEXT_LENGTH),
                            device=device),
      "z": torch.zeros((batch, config.z_dim), device=device),
  }


def quantize_params_int8(params: Mapping[str, Tensor]
                         ) -> Dict[str, Tuple[Tensor, Optional[Tensor]]]:
  """Weight-only per-channel symmetric int8 quantization of G's
  parameters (``named_parameters`` names, the port's layouts).

  Every floating tensor with ndim >= 2 (Dense ``[out, in]`` and conv OIHW
  kernels) becomes ``int8`` values and one float32 scale per output
  channel, axis 0 here and the trailing axis in flax's layouts:
  ``scale = max(amax, 1e-12) / 127``, ``q = clip(round(x / scale), -127,
  127)``, the JAX package's arithmetic.  Vectors (biases) pass through as
  ``(x, None)``.
  """
  out = {}
  for name, x in params.items():
    if x.is_floating_point() and x.dim() >= 2:
      xf = x.detach().float()
      amax = xf.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)
      scale = torch.clamp_min(amax, 1e-12) / 127.0
      q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
      out[name] = (q, scale)
    else:
      out[name] = (x, None)
  return out


def dequantize(q: Tensor, scale: Tensor, dtype: torch.dtype) -> Tensor:
  """An int8 kernel back in ``dtype``: ``(q * scale).astype(dtype)``."""
  return (q.float() * scale).to(dtype)


class ServingGenerator(nn.Module):
  """G as a pure inference function of the four serving inputs.

  Built from a trained ``generator`` (whose buffers are the BatchNorm
  running averages) and ``params``, the weights to serve (the EMA's, or
  None for G's own).  G runs in eval mode without remat and holds no
  mutable state.  For a bfloat16 configuration the parameters are stored
  in bfloat16: each layer casts its kernel and bias to the compute dtype
  at use, so the result is G's, bit for bit, at half the bytes; the
  running averages stay float32.  With ``quantize="int8"`` the kernels
  are int8 buffers with float32 scales (`quantize_params_int8`),
  dequantized to the compute dtype inside `forward`, so an exported
  program carries the int8 values.  A spectral layer (``g_spectral_norm``)
  normalizes the kernel it serves, the bfloat16 or the dequantized one,
  by its power iteration in float32 from its stored ``u0``: JAX's order
  and values.  In eval mode ``u0`` is a constant, so sigma is computed
  once, here: the normalized kernel is stored in place of the kernel
  (with int8, sigma beside the int8 values, and the dequantized kernel is
  divided by it in `forward`), and the graph holds no power iteration.
  Inputs are cast to the compute dtype; the output is float32 NHWC in
  [0, 1].
  """

  def __init__(self, config, generator: nn.Module,
               params: Optional[Mapping[str, Tensor]] = None, *,
               quantize: Optional[str] = None):
    super().__init__()
    if quantize not in (None, "int8"):
      raise ValueError(f"unknown quantize mode {quantize!r}")
    config = type(config)(config)
    config.remat = False   # a training knob; its dispatch modes stay out
    self.dtype = xmc_net.compute_dtype(config)
    state = dict(generator.state_dict())
    if params is not None:
      state.update(params)
    g = xmc_net.Generator(config, device="meta")
    param_names = {name for name, _ in g.named_parameters()}
    if set(params or {}) - param_names:
      raise ValueError(f"not parameters of G: "
                       f"{sorted(set(params) - param_names)[:5]}")
    cast = self.dtype if quantize is None else torch.float32
    g.load_state_dict({
        name: t.detach().to(cast if name in param_names else t.dtype,
                            copy=True)
        for name, t in state.items()}, assign=True)
    g.eval()
    g.requires_grad_(False)
    self.quantized = []
    if quantize == "int8":
      params = dict(g.named_parameters())
      for name, (q, scale) in quantize_params_int8(params).items():
        if scale is None:
          continue
        path, _, leaf = name.rpartition(".")
        layer = g.get_submodule(path)
        if leaf != "kernel" or not isinstance(layer, (Dense, Conv)):
          raise ValueError(f"cannot quantize {name}")
        layer.kernel = None
        layer.register_buffer("kernel_int8", q)
        layer.register_buffer("kernel_scale", scale)
        layer.register_buffer("kernel_sigma", None)
        if layer.spectral:
          layer.kernel_sigma, _ = power_iteration_normalize(
              layer._kernel_2d(dequantize(q, scale, self.dtype)), layer.u0)
        self.quantized.append(layer)
    for layer in g.modules():
      if isinstance(layer, (Dense, Conv)) and layer.spectral:
        if layer.kernel is not None:
          layer.kernel = nn.Parameter(layer.normalize(layer.kernel),
                                      requires_grad=False)
        layer.spectral = False
        del layer.u0
    self.generator = g

  def forward(self, sentence_embedding: Tensor, embedding: Tensor,
              max_len: Tensor, z: Tensor) -> Tensor:
    dtype = self.dtype
    cond = {"sentence_embedding": sentence_embedding.to(dtype),
            "embedding": embedding.to(dtype), "max_len": max_len.to(dtype)}
    kernels = []
    for layer in self.quantized:
      kernel = dequantize(layer.kernel_int8, layer.kernel_scale, dtype)
      if layer.kernel_sigma is not None:
        kernel = (kernel.float() / layer.kernel_sigma).to(dtype)
      kernels.append(kernel)
    with precomputed_kernels(self.quantized, kernels):
      images = self.generator(cond, z.to(dtype))
    return images.float()


@dataclasses.dataclass(frozen=True)
class ShardedExport:
  """A multi-device artifact before it is saved (JAX's ``Exported`` of
  ``export_generator(mesh=...)``): ``program`` serves ``batch_size //
  num_devices`` rows, and one call of the saved artifact serves
  ``batch_size`` rows over ``num_devices`` devices."""
  program: torch.export.ExportedProgram
  num_devices: int
  batch_size: int

  def save(self, f) -> None:
    """``torch.export.save`` of the program, with the placement recorded
    in `SHARDING_FILE`."""
    sharding = json.dumps({
        "mesh_axis": MESH_AXIS, "num_devices": self.num_devices,
        "batch_size": self.batch_size,
        "shard_batch_size": self.batch_size // self.num_devices})
    torch.export.save(self.program, f, extra_files={SHARDING_FILE: sharding})


def export_generator(generator: nn.Module,
                     params: Optional[Mapping[str, Tensor]], config, *,
                     batch_size: Optional[int] = None,
                     quantize: Optional[str] = None, device=None,
                     devices: Optional[Sequence[Any]] = None
                     ) -> Union[torch.export.ExportedProgram, ShardedExport]:
  """`ServingGenerator` of ``generator`` with ``params`` traced on
  ``device`` (``cuda`` by default) by ``torch.export``; ``batch_size=None``
  -> symbolic batch (traced at 2, served at any size from 1).

  ``devices``, N devices (repeats allowed), stands for the JAX package's
  ``mesh=`` with its ``data`` axis of N devices: ``batch_size`` must be
  static and divisible by N.  G is traced once, at ``batch_size // N``
  rows on ``devices[0]``, and a `ShardedExport` is returned."""
  if devices is not None:
    if device is not None:
      raise ValueError("pass device or devices, not both")
    if batch_size is None:
      raise ValueError("sharded export requires a static batch_size")
    n = len(devices)
    if not n or batch_size % n:
      raise ValueError(
          f"batch_size {batch_size} not divisible by mesh axis "
          f"{MESH_AXIS!r} ({n} devices)")
    for d in devices:
      check_device(d)
    program = export_generator(generator, params, config,
                               batch_size=batch_size // n,
                               quantize=quantize, device=devices[0])
    return ShardedExport(program, n, batch_size)
  device = check_device("cuda" if device is None else device)
  module = ServingGenerator(config, generator, params,
                            quantize=quantize).to(device)
  example = make_init_batch(config, batch_size or 2, device)
  args = tuple(example[k] for k in INPUTS)
  dynamic = None
  if batch_size is None:
    b = torch.export.Dim("b", min=1)
    dynamic = tuple({0: b} for _ in INPUTS)
  return torch.export.export(module, args, dynamic_shapes=dynamic,
                             strict=False)


def artifact_metadata(config, *, weights: str, step: Optional[int],
                      batch_size: Optional[int], device="cuda",
                      quantize: Optional[str] = None) -> str:
  """JSON sidecar describing the artifact's interface for consumers (the
  JAX package's keys; ``platforms`` lists the torch device types the
  artifact serves on, `SERVES_ON`, the traced one first)."""
  b: Any = batch_size if batch_size is not None else "b"
  traced = torch.device(device).type
  return json.dumps(
      {
          "weights": weights,
          "step": step,
          "platforms": list(SERVES_ON.get(traced, (traced,))),
          "quantization": quantize or "none",
          "image_size": config.image_size,
          "inputs": {
              "sentence_embedding": [b, BERT_DIM],
              "embedding": [b, COCO_MAX_TEXT_LENGTH, BERT_DIM],
              "max_len": [b, 1],
              "z": [b, config.z_dim],
          },
          "input_dtype": "float32",
          "output": {
              "image": [b, config.image_size, config.image_size, 3],
              "dtype": "float32",
              "range": [0.0, 1.0],
          },
      },
      indent=2, sort_keys=True)


def _move_program(program: torch.export.ExportedProgram, device
                 ) -> torch.export.ExportedProgram:
  """``program`` (changed in place) with its weights, buffers, constants
  and the devices named in its graph on ``device``.  Everything moves to
  the one device: ``move_to_device_pass``'s map form would leave a graph
  argument ``cuda`` behind when its key reads ``cuda:0``."""
  from torch.export.passes import move_to_device_pass

  return move_to_device_pass(program, str(check_device(device)))


class ShardedGenerator:
  """A sharded artifact served over N devices, one copy of its program a
  device (devices that repeat share theirs).  A call splits each of the
  four inputs of the global batch along dim 0 into N equal chunks, moves
  chunk i to ``devices[i]`` (from pinned memory where it is on the host),
  runs it there and concatenates the images on ``devices[0]``.  The JAX
  package's call returns an array sharded over the mesh instead."""

  def __init__(self, programs: Mapping[torch.device,
                                       torch.export.ExportedProgram],
               devices: Sequence[torch.device], batch_size: int):
    self.devices = list(devices)
    self.batch_size = batch_size
    self.modules = {d: p.module() for d, p in programs.items()}

  def __call__(self, *inputs: Tensor) -> Tensor:
    if len(inputs) != len(INPUTS):
      raise ValueError(f"expected the inputs {INPUTS}, got {len(inputs)}")
    for name, x in zip(INPUTS, inputs):
      if x.shape[0] != self.batch_size:
        raise ValueError(f"{name}: the artifact serves a batch of "
                         f"{self.batch_size}, got {x.shape[0]}")
    rows = self.batch_size // len(self.devices)
    images = []
    for i, device in enumerate(self.devices):
      chunk = (_place(x.narrow(0, i * rows, rows), device) for x in inputs)
      images.append(self.modules[device](*chunk))
    return torch.cat([x.to(self.devices[0]) for x in images])


def _place(x: Tensor, device: torch.device) -> Tensor:
  if x.device.type == "cpu" and device.type == "cuda":
    return (x if x.is_pinned() else x.pin_memory()).to(device,
                                                        non_blocking=True)
  return x.to(device)


def load_exported(path: str, device=None, *,
                  devices: Optional[Sequence[Any]] = None
                  ) -> Union[torch.export.ExportedProgram, ShardedGenerator]:
  """A saved artifact, local or on a store.

  ``device=None`` keeps the program where it was traced; a device moves
  it there (`_move_program`).  Call the result as
  ``.module()(*inputs)``.  Without ``devices`` a sharded artifact loads
  as its program of the shard's rows.

  ``devices``, for a sharded artifact, are as many devices as it was
  exported over (any of them, as JAX's ``in_shardings_jax(mesh)`` takes
  any mesh of that size): returns a `ShardedGenerator` of the artifact's
  global batch."""
  data = fileio.read_bytes(path)
  extra = {SHARDING_FILE: ""}
  program = torch.export.load(io.BytesIO(data), extra_files=extra)
  if devices is None:
    return program if device is None else _move_program(program, device)
  if device is not None:
    raise ValueError("pass device or devices, not both")
  if not extra[SHARDING_FILE]:
    raise ValueError(f"{path} is not a sharded artifact")
  sharding = json.loads(extra[SHARDING_FILE])
  if len(devices) != sharding["num_devices"]:
    raise ValueError(
        f"{path} is sharded over {sharding['num_devices']} devices, got "
        f"{len(devices)}")
  devices = [check_device(d) for d in devices]
  programs = {}
  for d in dict.fromkeys(devices):
    if programs:   # one more copy, from the bytes already read
      program = torch.export.load(io.BytesIO(data))
    programs[d] = _move_program(program, d)
  return ShardedGenerator(programs, devices, sharding["batch_size"])


def export_from_workdir(config, workdir: str, *, step: Optional[int] = None,
                        batch_size: Optional[int] = None,
                        weights: str = "ema", device="cuda",
                        out_dir: Optional[str] = None,
                        quantize: Optional[str] = None) -> List[str]:
  """Restores a checkpoint of a training workdir and writes serving
  artifacts, ``generator_{ema|normal}[_int8]_step{N:08d}.pt2`` and its
  ``.json``, under ``{workdir}/serving`` (or ``out_dir``); returns the
  artifacts' paths.  ``weights`` is ``"ema"``, ``"normal"`` or
  ``"both"``.  ``device`` is ``cuda:LOCAL_RANK`` for ``"cuda"``; over a
  process group process 0 alone restores and writes, and the others
  return the same paths once it has."""
  from xmcgan_image_generation_tpu_torch.parallel import collectives
  from xmcgan_image_generation_tpu_torch.parallel.mesh import MeshRules
  from xmcgan_image_generation_tpu_torch.utils.checkpoint import (
      CheckpointManager,
      checkpoints_dir,
  )

  if weights not in ("ema", "normal", "both"):
    raise ValueError(f"weights must be ema|normal|both, got {weights!r}")
  rules = MeshRules.create(config.get("mesh_data", -1),
                           config.get("mesh_model", 1), device=device)
  try:
    mesh = rules.mesh
    ckpt = CheckpointManager(checkpoints_dir(workdir))
    step = step if step is not None else ckpt.agreed_latest_step()
    if step is None:
      raise FileNotFoundError(
          f"No checkpoints in {checkpoints_dir(workdir)}")
    out_dir = out_dir or fileio.join(workdir, "serving")
    names = {"ema": ["ema"], "normal": ["normal"],
             "both": ["ema", "normal"]}[weights]
    suffix = f"_{quantize}" if quantize else ""
    bases = [fileio.join(out_dir, f"generator_{name}{suffix}_step{step:08d}")
             for name in names]
    if mesh.is_main:
      _write_artifacts(config, ckpt, step, names, bases, mesh.device,
                       batch_size, quantize)
    collectives.host_barrier()   # the artifacts are down
    return [base + ".pt2" for base in bases]
  finally:
    rules.shutdown()


def _restore_generator(config, ckpt, step: int, device: torch.device
                       ) -> Tuple[nn.Module, Dict[str, Tensor]]:
  """G (parameters and buffers) and its EMA from the checkpoint of
  ``step``.  A local file is memory-mapped, so that only G's tensors are
  read (a remote one is read whole): the export builds neither D nor the
  optimizers."""
  from xmcgan_image_generation_tpu_torch.utils import checkpoint

  path = ckpt.path(step)
  payload = checkpoint.load(
      path, map_location="cpu",
      **({} if fileio.is_remote(path) else {"mmap": True}))
  generator = xmc_net.Generator(config, device="meta")
  generator.load_state_dict({k: v.to(device) for k, v in
                             payload["generator"].items()}, assign=True)
  return generator, {k: v.to(device)
                     for k, v in payload["ema_params"].items()}


def _write_artifacts(config, ckpt, step: int, names: List[str],
                     bases: List[str], device: torch.device,
                     batch_size: Optional[int],
                     quantize: Optional[str]) -> None:
  generator, ema_params = _restore_generator(config, ckpt, step, device)
  fileio.makedirs(fileio.dirname(bases[0]))
  for name, base in zip(names, bases):
    params = ema_params if name == "ema" else None
    exported = export_generator(generator, params, config,
                                batch_size=batch_size, quantize=quantize,
                                device=device)
    # The archive's writer seeks, which a store's upload cannot: the
    # artifact is built in memory and published in one write.
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    fileio.atomic_write(base + ".pt2", buf.getvalue())
    with fileio.open(base + ".json", "w") as f:
      f.write(artifact_metadata(config, weights=name, step=step,
                                batch_size=batch_size, device=device,
                                quantize=quantize))

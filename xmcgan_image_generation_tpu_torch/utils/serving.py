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
and its weights live there; it serves on that device.

`export_from_workdir` (``--mode=export``) runs in every process of a
``torchrun`` job: process 0 restores the checkpoint and writes the
artifacts once, the others wait for it and return the same paths.  (The
JAX package lets every process write the same files.)

Not ported: the JAX package's ``export_generator(mesh=...)``, one
artifact whose single call splits a batch over the consumer's devices.
A ``torch.export`` program lives on one device and has no multi-device
form, so that artifact waits for a design: one program per device behind
a splitting wrapper, or a program with the collectives inside it.
"""

from __future__ import annotations

import importlib
import json
from typing import Any, Dict, List, Mapping, Optional, Tuple

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


def export_generator(generator: nn.Module,
                     params: Optional[Mapping[str, Tensor]], config, *,
                     batch_size: Optional[int] = None,
                     quantize: Optional[str] = None,
                     device="cuda") -> torch.export.ExportedProgram:
  """`ServingGenerator` of ``generator`` with ``params`` traced on
  ``device`` by ``torch.export``; ``batch_size=None`` -> symbolic batch
  (traced at 2, served at any size from 1)."""
  device = check_device(device)
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
  JAX package's keys; ``platforms`` names the torch device)."""
  b: Any = batch_size if batch_size is not None else "b"
  return json.dumps(
      {
          "weights": weights,
          "step": step,
          "platforms": [torch.device(device).type],
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


def load_exported(path: str) -> torch.export.ExportedProgram:
  """A saved artifact; call it as ``load_exported(path).module()(*inputs)``
  on the device it was exported for."""
  return torch.export.load(path)


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
  ``step``.  The file is memory-mapped and only G's tensors are read: the
  export builds neither D nor the optimizers."""
  payload = torch.load(ckpt.path(step), map_location="cpu",
                       weights_only=True, mmap=True)
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
    torch.export.save(exported, base + ".pt2")
    with open(base + ".json", "w") as f:
      f.write(artifact_metadata(config, weights=name, step=step,
                                batch_size=batch_size, device=device,
                                quantize=quantize))

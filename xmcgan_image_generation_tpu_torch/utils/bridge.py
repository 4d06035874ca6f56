"""Weight bridge between the JAX package's trees and the port's state.

The JAX side is nested dicts of numpy arrays, as ``jax.device_get`` gives
them: the flax collections ``params``, ``batch_stats`` and
``spectral_norm_stats`` and the optax Adam slots ``mu`` / ``nu`` /
``count``.  The port's side is a module's ``state_dict`` and a
``torch.optim.Adam``.  Module paths are the flax scope paths joined with
dots, so the mapping is by name; the layouts change as follows:

* conv kernels HWIO <-> OIHW;
* Dense kernels ``[in, out]`` <-> ``[out, in]``;
* ``u0`` stays a ``[1, out]`` buffer, BatchNorm ``mean`` / ``var`` stay
  vectors;
* batches NHWC <-> NCHW (`nhwc_to_nchw`, `nchw_to_nhwc`).

`flat_from_state_dict` and `state_dict_from_flat` read and write the JAX
package's flattened ``.npz`` layout of a variables tree (``'/'``-joined
paths under the collection, ``params/mixed0/b0_1x1/conv/kernel``), in
which converted InceptionV3 weights are stored.

This module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_STATS = {"mean": "batch_stats", "var": "batch_stats",
          "u0": "spectral_norm_stats"}


def flatten(tree: Mapping[str, Any], prefix: str = "",
            sep: str = ".") -> Dict[str, Any]:
  """``{"a": {"b": x}}`` -> ``{"a.b": x}`` (``sep`` joins the keys)."""
  out = {}
  for key, value in tree.items():
    name = f"{prefix}{key}"
    if isinstance(value, Mapping):
      out.update(flatten(value, name + sep, sep))
    else:
      out[name] = value
  return out


def unflatten(flat: Mapping[str, Any], sep: str = ".") -> Dict[str, Any]:
  """``{"a.b": x}`` -> ``{"a": {"b": x}}`` (keys split at ``sep``)."""
  out: Dict[str, Any] = {}
  for name, value in flat.items():
    node = out
    *parents, leaf = name.split(sep)
    for p in parents:
      node = node.setdefault(p, {})
    node[leaf] = value
  return out


def _kernel_to_torch(name: str, a: np.ndarray) -> np.ndarray:
  if name.rsplit(".", 1)[-1] == "kernel":
    if a.ndim == 4:
      return a.transpose(3, 2, 0, 1)   # HWIO -> OIHW
    if a.ndim == 2:
      return a.T                       # [in, out] -> [out, in]
  return a


def _kernel_to_jax(name: str, a: np.ndarray) -> np.ndarray:
  if name.rsplit(".", 1)[-1] == "kernel":
    if a.ndim == 4:
      return a.transpose(2, 3, 1, 0)   # OIHW -> HWIO
    if a.ndim == 2:
      return a.T
  return a


def tree_to_torch(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """A flax tree (any collection) -> ``{dotted name: tensor}``."""
  # np.array copies: the arrays JAX hands out are read-only.
  return {name: torch.from_numpy(np.array(
      _kernel_to_torch(name, np.asarray(v)), order="C"))
          for name, v in flatten(tree).items()}


def tensors_to_jax(tensors: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
  """``{dotted name: tensor}`` -> a nested flax-layout tree of numpy."""
  return unflatten({
      name: np.ascontiguousarray(_kernel_to_jax(
          name, t.detach().float().cpu().numpy()))
      for name, t in tensors.items()})


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, Any]:
  """``{"params": ..., "batch_stats": ..., ...}`` -> a ``state_dict``."""
  out = {}
  for collection in ("params", "batch_stats", "spectral_norm_stats"):
    out.update(tree_to_torch(variables.get(collection, {})))
  return out


def jax_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                        ) -> Dict[str, Any]:
  """A ``state_dict`` -> ``{"params": ..., "batch_stats": ...,
  "spectral_norm_stats": ...}`` (empty collections left out)."""
  split: Dict[str, Dict[str, torch.Tensor]] = {}
  for name, t in state_dict.items():
    leaf = name.rsplit(".", 1)[-1]
    split.setdefault(_STATS.get(leaf, "params"), {})[name] = t
  return {c: tensors_to_jax(ts) for c, ts in split.items()}


def flat_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, np.ndarray]:
  """A ``state_dict`` -> the JAX ``.npz`` layout: ``{"params/a/b/kernel":
  array, "batch_stats/a/bn/mean": array, ...}``."""
  return flatten(jax_from_state_dict(state_dict), sep="/")


def state_dict_from_flat(flat: Mapping[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
  """The JAX ``.npz`` layout -> a ``state_dict`` (inverse of
  `flat_from_state_dict`)."""
  return state_dict_from_jax(unflatten(dict(flat), sep="/"))


def load_jax_variables(module: nn.Module, variables: Mapping[str, Any]
                       ) -> None:
  """Copies flax variables into ``module`` (every name must match)."""
  sd = state_dict_from_jax(variables)
  own = module.state_dict()
  missing, extra = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
  bad = sorted(n for n in set(own) & set(sd)
               if tuple(own[n].shape) != tuple(sd[n].shape))
  if missing or extra or bad:
    raise ValueError(f"JAX variables do not fit the module: missing="
                     f"{missing[:5]} extra={extra[:5]} shape={bad[:5]}")
  module.load_state_dict(sd)


def load_adam_state(opt: torch.optim.Optimizer, module: nn.Module,
                    mu: Mapping[str, Any], nu: Mapping[str, Any],
                    count: int) -> None:
  """Puts optax Adam slots (trees shaped like ``params``) into ``opt``,
  whose parameters are ``module.named_parameters()``."""
  mu_t, nu_t = tree_to_torch(mu), tree_to_torch(nu)
  for name, p in module.named_parameters():
    opt.state[p] = {
        "step": torch.tensor(float(count)),
        "exp_avg": mu_t[name].to(p.device).clone(),
        "exp_avg_sq": nu_t[name].to(p.device).clone(),
    }
  for group in opt.param_groups:
    if "lr_count" in group:   # a schedule's count (engine.state)
      group["lr_count"] = count


def adam_state_to_jax(opt: torch.optim.Optimizer, module: nn.Module
                      ) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
  """``(mu, nu, count)`` of ``opt`` in the flax ``params`` layout.

  A parameter that has not been stepped yet has zero slots and count 0.
  """
  mu, nu, count = {}, {}, 0
  for name, p in module.named_parameters():
    st = opt.state.get(p)
    if st:
      mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
      count = int(st["step"])
    else:
      mu[name] = nu[name] = torch.zeros_like(p)
  return tensors_to_jax(mu), tensors_to_jax(nu), count


def nhwc_to_nchw(x):
  """A batch of images NHWC -> NCHW (numpy or torch)."""
  return (x.permute(0, 3, 1, 2) if isinstance(x, torch.Tensor)
          else np.transpose(x, (0, 3, 1, 2)))


def nchw_to_nhwc(x):
  """A batch of images NCHW -> NHWC (numpy or torch)."""
  return (x.permute(0, 2, 3, 1) if isinstance(x, torch.Tensor)
          else np.transpose(x, (0, 2, 3, 1)))


def to_tensors(batch: Mapping[str, np.ndarray],
               device: Optional[torch.device] = None
               ) -> Dict[str, torch.Tensor]:
  """A numpy batch -> tensors on ``device`` (layouts unchanged)."""
  return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
          for k, v in batch.items()}

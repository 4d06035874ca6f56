"""The collectives of data-parallel training (no JAX twin: XLA inserts
these itself under GSPMD).

Convention.  Every process computes the *global* losses: the features
that pool over the batch (the contrastive heads, the adversarial logits)
are gathered with `all_gather`, so each process holds the same ``[B,
...]`` tensors and the same loss.  The cotangent that reaches a gathered
tensor is therefore already the whole gradient, and `all_gather`'s
backward only takes this process's rows.  A process's parameters see only
its own rows, so the parameter gradients are **summed** over processes
(`all_reduce_grads`).  A tensor that is summed over processes and then
used on this process's rows alone (BatchNorm's sums) gets the partial
cotangent of those rows, which `all_reduce_with_grad`'s backward sums
again.

Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used (gloo has
no ``reduce_scatter``).  NCCL takes CUDA tensors only: a CPU tensor goes
through the process's device and comes back.  Every call adds to a count
of calls and bytes under ``"{op}/{tag}"`` (`counts`, `reset_counts`);
the bytes are what this process puts in: the tensor reduced or
broadcast, or its rows of a gather.  Without an ambient process group
(`parallel.context.active_mesh`) every function is the one-process
identity and counts nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from xmcgan_image_generation_tpu_torch.parallel import context

# Flat gradient buckets of at most this many bytes (DDP's default size).
BUCKET_BYTES = 25 * 2**20

_counts: Dict[str, List[int]] = {}


def reset_counts() -> None:
  _counts.clear()


def counts() -> Dict[str, Dict[str, int]]:
  """``{"{op}/{tag}": {"calls": n, "bytes": b}}`` since `reset_counts`."""
  return {k: {"calls": c, "bytes": b} for k, (c, b) in sorted(
      _counts.items())}


def _record(op: str, tag: str, nbytes: int) -> None:
  entry = _counts.setdefault(f"{op}/{tag}", [0, 0])
  entry[0] += 1
  entry[1] += int(nbytes)


def _mesh(mesh):
  return mesh if mesh is not None else context.active_mesh()


def _nbytes(t: torch.Tensor) -> int:
  return t.numel() * t.element_size()


def _comm(t: torch.Tensor, mesh) -> torch.Tensor:
  """``t`` where the backend can take it (contiguous; on the card for
  NCCL)."""
  if mesh.backend == "nccl" and t.device.type != "cuda":
    t = t.to(mesh.device)
  return t.contiguous()


def _gather(x: torch.Tensor, mesh, tag: str) -> torch.Tensor:
  """Every process's ``x`` concatenated along dim 0, in rank order."""
  xc = _comm(x, mesh)
  parts = [torch.empty_like(xc) for _ in range(mesh.world)]
  dist.all_gather(parts, xc, group=mesh.group)
  _record("all_gather", tag, _nbytes(xc))
  return torch.cat(parts).to(x.device)


def _reduce(x: torch.Tensor, mesh, op: str, tag: str,
            inplace: bool = False) -> torch.Tensor:
  """A reduced copy of ``x`` (``x`` itself with ``inplace``, when the
  backend can take it as it is)."""
  ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
  if op not in ops:
    raise ValueError(f"all_reduce op must be 'sum' or 'max', got {op!r}")
  xc = _comm(x, mesh)
  if xc is x and not inplace:
    xc = x.clone()
  dist.all_reduce(xc, op=ops[op], group=mesh.group)
  _record("all_reduce", tag, _nbytes(xc))
  return xc.to(x.device)


class _AllGather(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, tag):
    ctx.mesh, ctx.rows = mesh, x.shape[0]
    return _gather(x, mesh, tag)

  @staticmethod
  def backward(ctx, g):
    start = ctx.mesh.rank * ctx.rows
    return g[start:start + ctx.rows], None, None


def all_gather(x: torch.Tensor, mesh=None, tag: str = "rows"
               ) -> torch.Tensor:
  """Every process's rows of ``x`` along dim 0, differentiable: the
  backward takes this process's rows of the cotangent (see the module's
  convention)."""
  mesh = _mesh(mesh)
  if mesh is None:
    return x
  return _AllGather.apply(x, mesh, tag)


def gather_rows(x: torch.Tensor, mesh=None, tag: str = "rows"
                ) -> torch.Tensor:
  """`all_gather` without autograd (data, host arrays)."""
  mesh = _mesh(mesh)
  if mesh is None:
    return x
  with torch.no_grad():
    return _gather(x, mesh, tag)


def gather_batch(batch: Dict[str, torch.Tensor], mesh=None
                 ) -> Dict[str, torch.Tensor]:
  """Every process's rows of each tensor of ``batch``: the process-major
  global batch of the JAX package's ``make_array_from_process_local_data``
  (process ``p``'s rows are block ``p``)."""
  return {k: gather_rows(v, mesh, tag="batch") for k, v in batch.items()}


class _AllReduceWithGrad(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, tag):
    ctx.mesh, ctx.tag = mesh, tag
    return _reduce(x, mesh, "sum", tag)

  @staticmethod
  def backward(ctx, g):
    return _reduce(g, ctx.mesh, "sum", ctx.tag + "_grad"), None, None


def all_reduce_with_grad(x: torch.Tensor, mesh=None, tag: str = "sums"
                         ) -> torch.Tensor:
  """The sum of ``x`` over processes, whose backward sums the cotangent
  over processes too (for sums then used on each process's own rows)."""
  mesh = _mesh(mesh)
  if mesh is None:
    return x
  return _AllReduceWithGrad.apply(x, mesh, tag)


def all_reduce(x: torch.Tensor, op: str = "sum", mesh=None,
               tag: str = "values") -> torch.Tensor:
  """The sum or max of ``x`` over processes, outside autograd."""
  mesh = _mesh(mesh)
  if mesh is None:
    return x
  with torch.no_grad():
    return _reduce(x, mesh, op, tag)


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
  """Indices of ``tensors`` in lists of one dtype and device, each
  holding at most ``BUCKET_BYTES`` (or one larger tensor)."""
  by_kind: Dict[Tuple, List[int]] = {}
  for i, t in enumerate(tensors):
    by_kind.setdefault((t.dtype, t.device), []).append(i)
  out = []
  for idx in by_kind.values():
    current, size = [], 0
    for i in idx:
      n = _nbytes(tensors[i])
      if current and size + n > BUCKET_BYTES:
        out.append(current)
        current, size = [], 0
      current.append(i)
      size += n
    if current:
      out.append(current)
  return out


def all_reduce_grads(grads: Sequence[torch.Tensor], mesh=None
                     ) -> Tuple[torch.Tensor, ...]:
  """The gradients summed over processes, through flat buckets: one
  ``all_reduce`` a bucket.  Returns new tensors (views of the buckets)."""
  grads = list(grads)
  mesh = _mesh(mesh)
  if mesh is None:
    return tuple(grads)
  out: List[Optional[torch.Tensor]] = [None] * len(grads)
  with torch.no_grad():
    for idx in _buckets(grads):
      flat = torch.cat([grads[i].reshape(-1) for i in idx])
      flat = _reduce(flat, mesh, "sum", "grads", inplace=True)
      pieces = flat.split([grads[i].numel() for i in idx])
      for i, piece in zip(idx, pieces):
        out[i] = piece.view_as(grads[i])
  return tuple(out)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0, mesh=None
               ) -> None:
  """Overwrites ``tensors`` on every process with process ``src``'s, in
  flat buckets."""
  tensors = list(tensors)
  mesh = _mesh(mesh)
  if mesh is None:
    return
  with torch.no_grad():
    for idx in _buckets(tensors):
      flat = _comm(torch.cat([tensors[i].reshape(-1) for i in idx]), mesh)
      dist.broadcast(flat, src=src, group=mesh.group)
      _record("broadcast", "state", _nbytes(flat))
      pieces = flat.split([tensors[i].numel() for i in idx])
      for i, piece in zip(idx, pieces):
        tensors[i].copy_(piece.view_as(tensors[i]))


def barrier(mesh=None) -> None:
  """Returns once every process has called it (one small all_reduce)."""
  mesh = _mesh(mesh)
  if mesh is None:
    return
  device = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
  _reduce(torch.zeros(1, device=device), mesh, "sum", "barrier")

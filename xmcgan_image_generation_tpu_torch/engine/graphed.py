"""The updates' forward and backward as CUDA graphs, on one card.

On a CUDA device, with one microbatch an update (``grad_accum_steps``
1) and no process group, `engine.step.train_step` takes each update's
gradients from a captured ``torch.cuda.CUDAGraph`` (`eligible`): the
host then issues one replay an update, a few input copies, the Adam
steps and the EMA, where the eager update launches the kernels of G, D,
the heads and the ResNet-50 term one by one.  Everything else (the CPU,
the accumulated 256 px step, a process group) takes the eager update
unchanged.

`StepGraphs` holds the graphs of one `TrainState`: one a kind of update
(``critic``, ``joint``), signature of its sub-batch and set of the
objects the update reads besides (the config, the frozen tower): a graph
bakes those in, so another config or tower makes another graph.  The first
update of each runs eagerly on the side stream that captures: a real
update, and the warm-up of what is made once (a kernel's first build,
cuDNN's choice of algorithm, the allocator) or once a stream (cuBLAS's
workspace, the modulated-norm kernels' tickets).  The second captures
the update's forward and backward on that stream, reading static copies
of the sub-batch's tensors and writing static gradients
(``materialize_grads``) and losses.  Capture runs no kernel, so it
advances no state; the update then replays the graph, as every later
one does.  The graphs share one memory pool, which keeps an update's
activations between steps.

What the eager update decides on the host is baked into a graph: train
mode, G's frozen state in the critic update (`ops.normalization.
frozen_state`) and none in the joint one, each kernel's launch.  D's
``u0`` and G's BatchNorm statistics are written in place by kernels of
the graph, so they advance at every replay as they do eagerly.  Adam,
whose learning rate is a Python float, and the EMA stay eager, outside
the graphs.  A graph reads the parameters where they are: they are
updated in place, never replaced.

The kernel wrappers of `ops.cuda` count their launches as Python calls
(``.launches``), and a replay makes none.  So each counter's increase
during capture, which launched nothing, is taken back, and added again
at every replay: the counters equal the launches that ran.  The spans
``graph_capture`` and ``graph_replay`` (`utils.tracing`) mark a capture
and a replay; a replayed update has no ``forward`` or ``backward``.
"""

from __future__ import annotations

import contextlib
import importlib
import pkgutil
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from xmcgan_image_generation_tpu_torch.parallel import context
from xmcgan_image_generation_tpu_torch.utils import tracing

Batch = Dict[str, torch.Tensor]
Losses = Dict[str, torch.Tensor]
Update = Tuple[tuple, Losses]


def eligible(device, config) -> bool:
  """Whether the updates on ``device`` take the graphs: a CUDA device,
  one microbatch an update and no process group."""
  return (torch.device(device).type == "cuda"
          and int(config.get("grad_accum_steps", 1)) <= 1
          and context.active_mesh() is None
          and not (dist.is_available() and dist.is_initialized()))


def of(state, config) -> Optional["StepGraphs"]:
  """The state's graphs (made at the first call) when its updates take
  them, else None."""
  device = next(state.generator.parameters()).device
  if not eligible(device, config):
    return None
  if state.graphs is None:
    state.graphs = StepGraphs(device)
  return state.graphs


def launch_counters() -> List[Callable]:
  """The kernel wrappers of `ops.cuda` that count their launches."""
  from xmcgan_image_generation_tpu_torch.ops import cuda

  found = {}
  for info in pkgutil.iter_modules(cuda.__path__):
    module = importlib.import_module(f"{cuda.__name__}.{info.name}")
    for fn in vars(module).values():
      if callable(fn) and isinstance(getattr(fn, "launches", None), int):
        found[id(fn)] = fn
  return list(found.values())


class CudaGraph:
  """A ``torch.cuda.CUDAGraph`` captured on ``stream`` into ``pool``."""

  def __init__(self, stream: torch.cuda.Stream, pool):
    self._graph = torch.cuda.CUDAGraph()
    self._stream, self._pool = stream, pool

  def capture(self, fn: Callable[[], Update]) -> Update:
    # The loader's prefetch thread pins and copies batches meanwhile, on
    # its own stream: only this thread's calls are held to the capture's
    # rules (the autograd engine's thread only launches on the stream).
    with torch.cuda.graph(self._graph, pool=self._pool, stream=self._stream,
                          capture_error_mode="thread_local"):
      return fn()

  def replay(self) -> None:
    self._graph.replay()


class _Captured:
  """One update's graph, its static inputs and outputs, and the launches
  its capture counted."""

  def __init__(self, graph, inputs: Batch, grads: tuple, losses: Losses,
               launches: List[int]):
    self.graph, self.inputs = graph, inputs
    self.grads, self.losses, self.launches = grads, losses, launches

  def replay(self, batch: Batch, counters: List[Callable]) -> Update:
    for name, x in self.inputs.items():
      x.copy_(batch[name])
    with tracing.span("graph_replay"):
      self.graph.replay()
    for fn, n in zip(counters, self.launches):
      fn.launches += n
    # The next replay writes the static losses again; the caller may keep
    # these past it.
    return self.grads, {name: v.clone() for name, v in self.losses.items()}


def _signature(batch: Batch) -> tuple:
  return tuple((name, tuple(x.shape), x.dtype)
               for name, x in sorted(batch.items()))


class StepGraphs:
  """The captured updates of one training state on ``device``.

  ``new_graph`` makes the object that captures and replays an update
  (`CudaGraph` on the side stream, in one pool, by default; a stand-in
  needs ``capture(fn)`` and ``replay()``).
  """

  def __init__(self, device, new_graph: Optional[Callable] = None):
    self.stream = None
    if new_graph is None:
      self.stream = torch.cuda.Stream(torch.device(device))
      pool = torch.cuda.graph_pool_handle()
      new_graph = lambda: CudaGraph(self.stream, pool)  # noqa: E731
    self._new_graph = new_graph
    self._counters = launch_counters()
    # (kind, signature, ids of `bound`) -> None once warmed up, then its
    # `_Captured`; `_bound` keeps those objects alive, so no other object
    # takes their ids.
    self._updates: Dict[tuple, Optional[_Captured]] = {}
    self._bound: Dict[tuple, tuple] = {}

  def run(self, kind: str, fn: Callable[[Batch], Update], batch: Batch,
          bound: tuple = ()) -> Update:
    """``fn(batch)``, the ``(grads, losses)`` of one update of ``kind``:
    eagerly on the side stream the first time for the sub-batch's
    signature and the objects ``bound`` that ``fn`` reads besides the
    batch and the state, captured the second, replayed from then on."""
    key = (kind, _signature(batch), tuple(id(o) for o in bound))
    if key not in self._updates:
      self._updates[key], self._bound[key] = None, bound
      with self._side_stream():
        return fn(batch)
    captured = self._updates[key]
    if captured is None:
      captured = self._updates[key] = self._capture(fn, batch)
    return captured.replay(batch, self._counters)

  @contextlib.contextmanager
  def _side_stream(self):
    if self.stream is None:
      yield
      return
    current = torch.cuda.current_stream(self.stream.device)
    self.stream.wait_stream(current)
    with torch.cuda.stream(self.stream):
      yield
    current.wait_stream(self.stream)

  def _capture(self, fn, batch: Batch) -> _Captured:
    inputs = {name: x.clone() for name, x in batch.items()}
    graph = self._new_graph()
    before = [f.launches for f in self._counters]
    with tracing.span("graph_capture"):
      grads, losses = graph.capture(lambda: fn(inputs))
    launches = []
    for f, n in zip(self._counters, before):
      launches.append(f.launches - n)
      f.launches = n
    return _Captured(graph, inputs, grads, losses, launches)

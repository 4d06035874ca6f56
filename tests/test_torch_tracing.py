"""The training step's host spans (`utils.tracing`).

Without a profiler running an outer step records nothing.  Under a CPU
``torch.profiler`` one outer step of the 32 px test config, with two
D-steps a super-batch and two microbatches an update, records the tree
``step`` > ``data.wait``, ``d_update``, ``gd_update`` > leaves, the
leaves in the update's order; spans nest or lie apart, the leaves never
overlap, and the profiler's trace holds the step as ``step#<n>`` around
all of them.  A span's stamps are on the profiler's clock: an operator
run inside a span has its profiler event within the span's stamps.  The
record is bounded, drops the oldest spans and counts them, and the
trainer's ``profile=True`` capture shows the step and its phases.
"""

import glob
import json
import time

import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu_torch import train as train_lib
from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.data import synthetic
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.utils import bridge, tracing
from xmcgan_image_generation_tpu_torch.utils.metric_writer import Profile

torch.set_num_threads(1)

CPU = torch.device("cpu")
LEAVES = ("forward", "backward", "reduce_grads", "adam", "ema")
# One update's leaves in order, k = 2 microbatches: each microbatch's
# forward, backward and float32 sum, then the mean over microbatches and
# the sum over processes, then the optimizers' applies.
MICROBATCHES = ["forward", "backward", "reduce_grads"] * 2 + ["reduce_grads"]
CRITIC = MICROBATCHES + ["adam"]
JOINT = MICROBATCHES + ["adam", "adam", "ema"]


def _profiler():
  return torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def run():
  config = coco_xmc.get_test_config()
  config.batch_size = 4
  config.d_step_per_g_step = 2
  config.grad_accum_steps = 2
  state = create_train_state(config, "cpu", seed=0)
  rng = np.random.default_rng(0)
  batches = iter([bridge.to_tensors(synthetic.super_batch(config, rng))
                  for _ in range(4)])
  return (state, {}, batches), config


def test_an_untraced_step_records_no_span(run):
  program, config = run
  tracing.clear()
  assert not torch.autograd.profiler._is_profiler_enabled
  assert tracing.span("step") is tracing.span("forward")
  train_lib.timed_step(program, config, CPU)
  assert tracing.spans() == [] and tracing.dropped() == 0


@pytest.fixture(scope="module")
def traced(run):
  program, config = run
  tracing.clear()
  step = program[0].step + 1
  with _profiler() as prof:
    train_lib.timed_step(program, config, CPU)
  events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]
  return tracing.spans(), step, events


def _tree(spans):
  """Each span's children, in order: a span's parent is the innermost
  span that holds it in time."""
  ordered = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
  children = {s: [] for s in ordered}
  roots, open_ = [], []
  for s in ordered:
    while open_ and open_[-1].end_ns < s.end_ns:
      open_.pop()
    (children[open_[-1]] if open_ else roots).append(s)
    open_.append(s)
  return roots, children


def test_one_step_gives_the_tree(traced):
  spans, _, _ = traced
  roots, children = _tree(spans)
  assert [s.name for s in roots] == ["step"]
  assert [s.name for s in children[roots[0]]] == [
      "data.wait", "d_update", "gd_update"]
  _, d_update, gd_update = children[roots[0]]
  assert [s.name for s in children[d_update]] == CRITIC
  assert [s.name for s in children[gd_update]] == JOINT
  assert len(spans) == 4 + len(CRITIC) + len(JOINT)


def test_children_lie_inside_their_parents(traced):
  """Any two spans nest or lie apart, so each span's parent (the
  innermost span holding its start) holds it whole."""
  spans, _, _ = traced
  for s in spans:
    assert s.start_ns <= s.end_ns

  def holds(a, b):
    return a.start_ns <= b.start_ns and b.end_ns <= a.end_ns

  for a in spans:
    for b in spans:
      apart = a.end_ns <= b.start_ns or b.end_ns <= a.start_ns
      assert apart or holds(a, b) or holds(b, a), (a, b)
  _, children = _tree(spans)
  for parent, kids in children.items():
    assert all(holds(parent, kid) for kid in kids)


def test_leaves_never_overlap(traced):
  spans, _, _ = traced
  leaves = sorted((s for s in spans if s.name in LEAVES),
                  key=lambda s: s.start_ns)
  assert len(leaves) == len(CRITIC) + len(JOINT)
  for a, b in zip(leaves, leaves[1:]):
    assert a.end_ns <= b.start_ns
  _, children = _tree(spans)
  assert not any(children[s] for s in leaves)


def test_the_step_number_is_in_the_profilers_trace(traced):
  """The capture's trace names the outer step ``step#<n>``, once, and
  that range holds every span of the step; the record keeps the bare
  name."""
  spans, step, events = traced
  (numbered,) = [e for e in events if e[0].startswith("step#")]
  name, start, end = numbered
  assert name == f"step#{step}"
  assert not any(e[0] == "step" for e in events)
  assert [s.name for s in spans].count("step") == 1
  for s in spans:
    assert start <= s.start_ns and s.end_ns <= end, s


def test_stamps_are_on_the_profilers_clock():
  """The profiler's event of an operator run inside a span falls within
  the span's stamps (each side of the operator has a millisecond of
  host time, far above the profiler's conversion error)."""
  tracing.clear()
  x = torch.randn(256, 256)
  with _profiler() as prof:
    with tracing.span("probe"):
      time.sleep(1e-3)
      torch.mm(x, x)
      time.sleep(1e-3)
  (probe,) = tracing.spans()
  events = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "aten::mm"]
  assert len(events) == 1
  start = events[0].start_ns()
  end = start + events[0].duration_ns()
  assert probe.start_ns <= start < end <= probe.end_ns


def test_the_record_is_bounded(monkeypatch):
  monkeypatch.setattr(tracing, "CAPACITY", 3)
  tracing.clear()
  with _profiler():
    for i in range(5):
      with tracing.span(f"s{i}"):
        pass
  assert [s.name for s in tracing.spans()] == ["s2", "s3", "s4"]
  assert tracing.dropped() == 2
  tracing.clear()
  assert tracing.spans() == [] and tracing.dropped() == 0
  monkeypatch.undo()
  tracing.clear()
  with _profiler():
    for i in range(5):
      with tracing.span(f"s{i}"):
        pass
  assert len(tracing.spans()) == 5 and tracing.dropped() == 0


def test_the_trainers_capture_shows_the_step_and_its_phases(run, tmp_path):
  program, config = run
  profile = Profile(str(tmp_path), profile_step=1, num_profile_steps=1)
  profile(1)
  train_lib.timed_step(program, config, CPU)
  profile(2)
  (path,) = glob.glob(str(tmp_path / "plugins/profile/*.pt.trace.json"))
  with open(path) as f:
    names = {e.get("name") for e in json.load(f)["traceEvents"]}
  assert {"data.wait", "d_update", "gd_update", *LEAVES} <= names
  assert any(str(n).startswith("step#") for n in names)

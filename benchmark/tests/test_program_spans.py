"""The per-layer metrics that read the port's spans
(`benchmark.program_spans`): on made-up spans and device operations,
each reader's mean a step, and None where there is nothing to read; on
the card, spans recorded under the benchmark's CUDA-only `trace.Tracer`
share the device operations' clock and add no operation of their own."""

import sys
import types

import pytest
import torch

from benchmark import cells, trace
from xmcgan_image_generation_tpu_torch.utils import tracing

MS = 1_000_000  # ns
STEP = 1000 * MS
READERS = ("dispatch_ms.train", "forward_idle_ms.train",
           "backward_idle_ms.train", "update_idle_ms.train",
           "update_host_ms.train")


def _step_spans(offset):
  """One outer step's spans, in ms from ``offset``."""
  rows = [("step", 100, 900), ("data.wait", 100, 150),
          ("gd_update", 160, 750), ("forward", 160, 400),
          ("backward", 400, 600), ("reduce_grads", 600, 650),
          ("adam", 650, 700), ("ema", 700, 750)]
  return [tracing.Span(name, offset + a * MS, offset + b * MS)
          for name, a, b in rows]


def _step_ops(offset):
  """Busy (0, 100), (200, 300), (450, 500), (660, 680), (760, 1000): the
  card idles 40 + 100 ms in forward, 50 + 100 in backward, 50 in
  reduce_grads, 10 + 20 in adam, 50 in ema, 50 in data.wait."""
  return [(f"kernel_{a}", offset + a * MS, offset + b * MS)
          for a, b in ((0, 100), (200, 300), (450, 500), (660, 680),
                       (760, 1000))]


def _record(steps=2, kind="train", shift=0):
  spans = [s for i in range(steps) for s in _step_spans(i * STEP)]
  ops = [(n, a + shift, b + shift) for i in range(steps)
         for n, a, b in _step_ops(i * STEP)]
  record = types.SimpleNamespace(
      kind=kind, steps=steps, work=steps,
      trace=trace.Trace(ops=ops, start_ns=0, end_ns=steps * STEP,
                        spans=[]))
  return record, spans


@pytest.fixture
def recorded(monkeypatch):
  """Hands the readers the made-up spans in place of the port's record."""
  def use(spans):
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
  return use


def _read(name, record):
  return cells.reader(name).read(record)


def test_each_reader_is_a_mean_a_step(recorded):
  record, spans = _record()
  recorded(spans)
  want = {"dispatch_ms.train": 750.0, "forward_idle_ms.train": 140.0,
          "backward_idle_ms.train": 150.0, "update_idle_ms.train": 130.0,
          "update_host_ms.train": 150.0}
  got = {name: _read(name, record) for name in READERS}
  assert got == pytest.approx(want)


def test_the_leaves_idle_and_the_rest_make_the_window_idle(recorded):
  record, spans = _record()
  recorded(spans)
  leaves = sum(_read(n, record) for n in READERS if "idle" in n)
  # Idle outside the leaves: data.wait 50, the step's start 10 (150-160)
  # and the end of the window 10 (750-760) a step.
  total = 1e3 * (record.trace.window_s - record.trace.busy_s) / record.steps
  assert leaves == pytest.approx(420.0)
  assert total - leaves == pytest.approx(50.0 + 10.0 + 10.0)


def test_spans_outside_the_window_are_left_out(recorded):
  record, spans = _record()
  late = [s._replace(start_ns=s.start_ns + 5 * STEP,
                     end_ns=s.end_ns + 5 * STEP) for s in spans]
  recorded(spans + late)
  assert _read("forward_idle_ms.train", record) == pytest.approx(140.0)
  assert _read("update_host_ms.train", record) == pytest.approx(150.0)


def test_nothing_to_read_gives_none(recorded):
  record, spans = _record()
  recorded(spans)
  serve, _ = _record(kind="serve")
  untraced, _ = _record()
  untraced.trace = None
  fewer, _ = _record()
  fewer.steps = 3  # step spans that do not number the window's steps
  for name in READERS:
    for r in (serve, untraced, fewer):
      assert _read(name, r) is None, (name, r)
  recorded([])
  for name in READERS:
    assert _read(name, record) is None


def test_a_record_that_dropped_spans_gives_none(recorded, monkeypatch):
  record, spans = _record()
  recorded(spans)
  assert _read("dispatch_ms.train", record) == pytest.approx(750.0)
  monkeypatch.setattr(tracing, "dropped", lambda: 1)
  for name in READERS:
    assert _read(name, record) is None


def test_unaligned_clocks_give_no_idle(recorded):
  record, spans = _record(shift=10 ** 12)
  recorded(spans)
  assert not record.trace.aligned()
  for name in READERS:
    value = _read(name, record)
    assert (value is None) == ("idle" in name), name


def test_a_port_without_the_recorder_gives_none(monkeypatch):
  """Traced runs lay this benchmark over an older port's checkout too."""
  record, _ = _record()
  monkeypatch.delattr(sys.modules["xmcgan_image_generation_tpu_torch.utils"],
                      "tracing")
  monkeypatch.setitem(sys.modules,
                      "xmcgan_image_generation_tpu_torch.utils.tracing", None)
  for name in READERS:
    assert _read(name, record) is None


@pytest.mark.gpu
def test_spans_share_the_device_clock_and_add_no_operation():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the profiler's device stamps")
  x = torch.randn(2048, 2048, device="cuda")
  torch.cuda.synchronize()
  tracing.clear()
  with trace.Tracer() as tracer:
    start = trace.now_ns()
    for name in ("forward", "backward", "adam"):
      with tracing.span(name):
        for _ in range(10):
          x = x @ x
          x = x / x.norm()
        torch.cuda.synchronize()
    end = trace.now_ns()
  t = tracer.trace(start, end, trace.Spans())
  spans = tracing.spans()
  assert [s.name for s in spans] == ["forward", "backward", "adam"]
  assert t.aligned() and len(t.ops) >= 60
  # Each span synchronizes before it ends, so its operations lie inside
  # it, on the host clock, up to the profiler's conversion.
  slack = 200_000
  for s in spans:
    inside = [op for op in t.ops
              if s.start_ns - slack <= op[1] and op[2] <= s.end_ns + slack]
    assert len(inside) >= 20, s.name
  assert all(any(s.start_ns - slack <= op[1] and op[2] <= s.end_ns + slack
                 for s in spans) for op in t.ops)
  names = {s.name for s in spans}
  assert not any(op[0] in names for op in t.ops)

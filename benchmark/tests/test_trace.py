"""The trace's reductions (busy time, idle gaps by host span, groups) on
made-up events, and on the card the profiler's stamps in the host's
clock."""

import pytest
import torch

from benchmark import trace


def _trace():
  ops = [("void at::native::elementwise_kernel<add>", 100, 200),
         ("cudnn_conv_fprop", 150, 300),
         ("scores_fwd(float const*)", 400, 450),
         ("Memcpy HtoD (Pageable -> Device)", 500, 520)]
  spans = [("data wait", 0, 120), ("step dispatch", 120, 600),
           ("final synchronize", 600, 1000)]
  return trace.Trace(ops=ops, start_ns=0, end_ns=1000, spans=spans)


def test_busy_is_the_union():
  t = _trace()
  assert t.busy_intervals() == [(100, 300), (400, 450), (500, 520)]
  assert t.busy_s == pytest.approx(270e-9)
  assert t.window_s == pytest.approx(1e-6)


def test_idle_by_host_span():
  idle = _trace().idle_by_span()
  assert idle == pytest.approx({"data wait": 100e-9,
                                "step dispatch": 230e-9,
                                "final synchronize": 400e-9})


def test_groups_and_breakdown():
  t = _trace()
  assert trace.group("Memcpy HtoD (Pageable -> Device)") == "transfers"
  assert trace.group("scores_fwd(float const*)") == "port kernels"
  assert t.device_seconds(groups=("elementwise / copy",)) == pytest.approx(
      100e-9)
  assert t.device_seconds(("scores_",)) == pytest.approx(50e-9)
  out = t.breakdown()
  assert out["device_ops"][0] == ["convolution: cudnn_conv_fprop",
                                  pytest.approx(150e-9)]
  assert [g[0] for g in out["idle_gaps"]] == [
      "host in final synchronize", "host in step dispatch",
      "host in data wait"]
  assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10


def test_unaligned_clocks_are_named():
  t = _trace()
  t.ops = [(n, a + 10 ** 12, b + 10 ** 12) for n, a, b in t.ops]
  assert not t.aligned()
  assert list(t.idle_by_span()) == ["unaligned"]


@pytest.mark.gpu
def test_profiler_stamps_share_the_host_clock():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the profiler's device stamps")
  x = torch.randn(2048, 2048, device="cuda")
  torch.cuda.synchronize()
  with trace.Tracer() as tracer:
    start = trace.now_ns()
    for _ in range(20):
      x = x @ x
      x = x / x.norm()
    torch.cuda.synchronize()
    end = trace.now_ns()
  t = tracer.trace(start, end, trace.Spans())
  assert len(t.ops) >= 40
  assert t.aligned()
  assert 0 < t.busy_s <= t.window_s

"""The updates as CUDA graphs (`engine.graphed`) against the eager updates.

CPU tests:
* the rule: a CUDA device with one microbatch an update and no process
  group takes the graphs; the CPU, ``grad_accum_steps`` 2 and a process
  group take the eager updates, and a CPU step leaves the state without
  graphs;
* the plumbing, with a stand-in for the graph object that keeps a CUDA
  graph's contract on the CPU (capture leaves the state as it was and
  returns static outputs; a replay writes fresh values into them from the
  static inputs): four outer steps of the test config through
  `train_step` (step 1 warm-up, step 2 capture and replay, steps 3-4
  replays) equal four eager steps bit for bit, every step's losses,
  parameters, Adam slots, BatchNorm statistics, ``u0`` and the EMA, in
  the fused layout and in the reference one (``fused_spatial_cond``
  False, ``g_spectral_norm``: G's ``u0`` and its local conditional
  BatchNorms);
* the launch counters: a capture's increase is taken back and added again
  at every replay, so they count what an eager run counts;
* another config or another frozen tower is another graph: it is warmed
  up and captured anew, never a replay of the old one.

GPU tests (marker ``gpu``): four outer steps graphed against four eager
from the same seed and state on the card, at the test config, at the
flagship (`coco_xmc`, 2 x 56 at 128 px, the kernels and the ResNet-50
term) and at the flagship in the reference layout, with cuDNN held to deterministic algorithms on both sides; the
same quantities bit for bit, and each kernel counter's increase over the
four steps equal.  They skip without a card; on the card run ``python -m
pytest -m gpu --noconftest tests/test_torch_graphed.py``.  The file
imports no JAX.
"""

import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu_torch.configs import coco_xmc
from xmcgan_image_generation_tpu_torch.data import synthetic
from xmcgan_image_generation_tpu_torch.data.prefetch import DevicePrefetcher
from xmcgan_image_generation_tpu_torch.engine import graphed
from xmcgan_image_generation_tpu_torch.engine import xmc_gan
from xmcgan_image_generation_tpu_torch.engine.state import create_train_state
from xmcgan_image_generation_tpu_torch.engine.step import train_step
from xmcgan_image_generation_tpu_torch.ops.cuda import word_scores
from xmcgan_image_generation_tpu_torch.parallel.mesh import MeshRules
from xmcgan_image_generation_tpu_torch.utils import bridge

STEPS = 4
LAYOUTS = ("fused", "reference")
LOSSES = ("d_loss", "g_loss", "c_loss_d", "c_loss_g", "c_loss_g_pretrained")


def _layout(config, layout):
  """``config`` in ``layout``: as it is, or the concatenated, spectral-G
  reference layout."""
  if layout == "reference":
    config.update(fused_spatial_cond=False, g_spectral_norm=True)
  return config


def _nets(state):
  return (state.generator, state.discriminator)


def _module_tensors(state):
  return [t for net in _nets(state)
          for t in list(net.parameters()) + list(net.buffers())]


def _flat(out):
  grads, losses = out
  return [g for part in grads for g in part] + [losses[k]
                                                for k in sorted(losses)]


def _uncounted(fn):
  """``fn()`` with the kernels' launch counters left as they were: a
  replay makes no Python call of a wrapper."""
  counters = graphed.launch_counters()
  before = [f.launches for f in counters]
  out = fn()
  for f, n in zip(counters, before):
    f.launches = n
  return out


class StandInGraph:
  """A CUDA graph's contract on the CPU.  Capture runs the function but
  puts ``state``'s parameters and buffers back as they were (a capture
  runs no kernel) and returns its outputs; a replay runs it again on the
  same static inputs, counting no launch, and writes the results into
  those outputs.  ``log`` records each capture and replay."""

  def __init__(self, state=None, log=None):
    self.state, self.log = state, [] if log is None else log

  def capture(self, fn):
    saved = ([] if self.state is None else
             [t.detach().clone() for t in _module_tensors(self.state)])
    out = fn()
    if self.state is not None:
      with torch.no_grad():
        for t, v in zip(_module_tensors(self.state), saved):
          t.copy_(v)
    self.fn, self.out = fn, out
    self.log.append("capture")
    return out

  def replay(self):
    for static, fresh in zip(_flat(self.out), _flat(_uncounted(self.fn))):
      static.copy_(fresh)
    self.log.append("replay")


# ---------------------------------------------------------------------------
# The rule.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device,accum,takes", [
    ("cuda", 1, True), ("cpu", 1, False), ("cuda", 2, False),
    ("cpu", 2, False)])
def test_the_rule(device, accum, takes):
  config = coco_xmc.get_test_config()
  config.grad_accum_steps = accum
  assert graphed.eligible(torch.device(device), config) is takes


def test_a_process_group_takes_the_eager_updates(tmp_path):
  config = coco_xmc.get_test_config()
  rules = MeshRules.create(device="cpu", backend="gloo", rank=0,
                           world_size=1,
                           init_method=f"file://{tmp_path / 'store'}")
  try:
    assert not graphed.eligible(torch.device("cuda"), config)
  finally:
    rules.shutdown()
  assert graphed.eligible(torch.device("cuda"), config)


# ---------------------------------------------------------------------------
# The plumbing, with the stand-in.
# ---------------------------------------------------------------------------


def _batches(config, device, n=STEPS, seed=0):
  rng = np.random.default_rng(seed)
  return [{k: v.to(device) for k, v in
           bridge.to_tensors(synthetic.super_batch(config, rng)).items()}
          for _ in range(n)]


def _outcome(state, losses, counters=None):
  """What the steps left, on the host."""

  def host(tensors):
    return {name: t.detach().cpu().clone() for name, t in tensors}

  slots = {}
  for net, opt in ((state.generator, state.g_opt),
                   (state.discriminator, state.d_opt)):
    for name, p in net.named_parameters():
      for slot, v in opt.state[p].items():
        slots[f"{type(net).__name__}.{name}.{slot}"] = (
            v.detach().cpu().clone())
  return dict(
      losses=[{k: float(v[k]) for k in LOSSES} for v in losses],
      g=host(state.generator.named_parameters()),
      d=host(state.discriminator.named_parameters()),
      g_buffers=host(state.generator.named_buffers()),
      d_buffers=host(state.discriminator.named_buffers()),
      ema=host(state.ema_params.items()), slots=slots, step=state.step,
      counters=counters)


def _differences(a, b):
  """Names whose tensors differ in any bit, with the largest |a - b|."""
  out = {}
  for group in ("g", "d", "g_buffers", "d_buffers", "ema", "slots"):
    assert a[group].keys() == b[group].keys()
    for name, x in a[group].items():
      y = b[group][name]
      if not torch.equal(x, y):
        out[f"{group}:{name}"] = float((x.float() - y.float()).abs().max())
  return out


def _steps(state, config, batches, additional):
  losses = []
  for batch in batches:
    _, metrics = train_step(state, batch, config, additional)
    losses.append(metrics)
  return losses


def test_a_cpu_step_stays_eager():
  config = coco_xmc.get_test_config()
  state = create_train_state(config, "cpu", seed=0)
  _steps(state, config, _batches(config, "cpu", n=1), {})
  assert state.graphs is None and state.step == 1


@pytest.fixture(scope="module", params=LAYOUTS)
def stand_in_runs(request):
  config = _layout(coco_xmc.get_test_config(), request.param)
  batches = _batches(config, "cpu")
  eager = create_train_state(config, "cpu", seed=0)
  eager_out = _outcome(eager, _steps(eager, config, batches, {}))
  state = create_train_state(config, "cpu", seed=0)
  log = []
  state.graphs = graphed.StepGraphs(
      "cpu", new_graph=lambda: StandInGraph(state, log))
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(graphed, "eligible", lambda device, config: True)
    out = _outcome(state, _steps(state, config, batches, {}))
  return eager_out, out, log


def test_stand_in_steps_equal_the_eager_steps(stand_in_runs):
  eager, graphs, _ = stand_in_runs
  assert graphs["step"] == eager["step"] == STEPS
  assert graphs["losses"] == eager["losses"]
  assert _differences(graphs, eager) == {}
  assert any(name.endswith("u0") for name in eager["d_buffers"])


def test_the_reference_layout_advances_g_u0():
  """G's ``u0`` is compared above in the reference layout, and moves."""
  config = _layout(coco_xmc.get_test_config(), "reference")
  state = create_train_state(config, "cpu", seed=0)
  before = {n: b.clone() for n, b in state.generator.named_buffers()
            if n.endswith("u0")}
  _steps(state, config, _batches(config, "cpu", n=1), {})
  assert before and all(
      not torch.equal(b, dict(state.generator.named_buffers())[n])
      for n, b in before.items())


def test_each_update_is_captured_once_then_replayed(stand_in_runs):
  """Step 1 warms both updates up, step 2 captures each and replays it,
  steps 3 and 4 replay."""
  _, _, log = stand_in_runs
  assert log.count("capture") == 2
  assert log.count("replay") == 2 * (STEPS - 1)
  assert log[:4] == ["capture", "replay", "capture", "replay"]


def test_counters_follow_the_replays(monkeypatch):
  """A function that counts two launches a call: warm-up, capture and
  three replays count as four eager calls."""
  monkeypatch.setattr(word_scores.scores, "launches", 0)

  def update(batch):
    word_scores.scores.launches += 2
    return ((batch["x"] * 2,),), {"loss": batch["x"].sum()}

  graphs = graphed.StepGraphs("cpu", new_graph=StandInGraph)
  outs = [graphs.run("critic", update, {"x": torch.full((3,), float(i))})
          for i in range(4)]
  assert word_scores.scores.launches == 2 * 4
  # Static gradients, fresh losses, each from its own batch.
  assert outs[3][0][0][0] is outs[2][0][0][0]
  assert [float(o[1]["loss"]) for o in outs] == [0.0, 3.0, 6.0, 9.0]


def test_another_config_or_tower_is_another_graph():
  """The config and the frozen tower are baked into a graph: another of
  either is warmed up and captured anew; the same ones replay."""
  log = []
  graphs = graphed.StepGraphs("cpu", new_graph=lambda: StandInGraph(log=log))
  config, other = coco_xmc.get_test_config(), coco_xmc.get_test_config()
  tower, other_tower = torch.nn.Identity(), torch.nn.Identity()

  def update(batch):
    return ((batch["x"] * 2,),), {"loss": batch["x"].sum()}

  def run(*bound):
    graphs.run("joint", update, {"x": torch.ones(3)}, bound)
    return list(log)

  assert run(config, tower) == []                   # warm-up
  assert run(config, tower) == ["capture", "replay"]
  assert run(other, tower) == ["capture", "replay"]  # warm-up
  assert run(config, other_tower) == ["capture", "replay"]
  assert run(config, tower) == ["capture", "replay", "replay"]
  assert run(other, tower) == ["capture", "replay", "replay", "capture",
                               "replay"]


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  return torch.device("cuda")


def _card_config(name):
  if name == "test":
    return coco_xmc.get_test_config()
  if name == "reference":
    return _layout(coco_xmc.get_config(), "reference")
  return coco_xmc.get_config()


class _Feed:
  """Host super-batches for a `DevicePrefetcher`, as the loader gives
  them."""

  def __init__(self, batches):
    self.batches, self.index = batches, 0

  def __next__(self):
    self.index += 1
    return self.batches[self.index - 1]

  def get_state(self):
    return {"index": self.index}

  def close(self):
    pass


def _card_run(config, device, graphs: bool):
  """Four outer steps on super-batches from the loader's prefetch thread,
  which pins and copies the next batches while a step captures."""
  counters = graphed.launch_counters()
  state = create_train_state(config, device, seed=0)
  torch.manual_seed(0)   # the tower's random weights, where there is one
  additional = xmc_gan.create_additional_data(config, device)
  feed = _Feed(_batches(config, "cpu") + _batches(config, "cpu", seed=1))
  batches = DevicePrefetcher(feed, device, size=2)
  before = [f.launches for f in counters]
  try:
    with pytest.MonkeyPatch.context() as mp:
      if not graphs:
        mp.setattr(graphed, "eligible", lambda device, config: False)
      losses = _steps(state, config, [next(batches) for _ in range(STEPS)],
                      additional)
  finally:
    batches.close()
  torch.cuda.synchronize(device)
  assert (state.graphs is not None) is graphs
  return _outcome(state, losses, {
      f.__name__: f.launches - n for f, n in zip(counters, before)})


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["test", "flagship", "reference"])
def test_gpu_graphed_steps_equal_eager_steps(cuda, name):
  config = _card_config(name)
  saved = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
  torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
      True, False)
  try:
    eager = _card_run(config, cuda, graphs=False)
    out = _card_run(config, cuda, graphs=True)
  finally:
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved
  assert out["counters"] == eager["counters"]
  if name != "test":
    for kernel in ("norm_stats", "ntxent_stats", "scores", "drn"):
      assert eager["counters"][kernel] > 0, eager["counters"]
  assert out["losses"] == eager["losses"]
  assert _differences(out, eager) == {}

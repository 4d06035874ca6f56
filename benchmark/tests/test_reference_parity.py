"""The frozen reference against the port on the CPU, at small sizes in
float32: one outer step of ``engine.step.train_step`` with the einsum
heads (losses, Adam's moments, G and D, the EMA, BatchNorm statistics and
``u0``), and ``utils.serving.ServingGenerator``'s images.  The reference
imports nothing of the port; this test is where the two meet."""

import pytest
import torch
import torch.nn.functional as F

from benchmark import cells, compare, weights
from benchmark.reference import layers
from benchmark.reference import step as ref

SEED = 2 ** 31 + 99


def _config(**over):
  from xmcgan_image_generation_tpu_torch.configs import coco_xmc

  cfg = coco_xmc.get_test_config()
  cfg.update(dtype="float32", batch_size=4, use_pallas=False)
  cfg.update(over)
  return cfg


def _batch(cfg, seed=3):
  g = torch.Generator().manual_seed(seed)
  n, s = cfg.batch_size * cfg.d_step_per_g_step, cfg.image_size
  return {"image": torch.randint(0, 256, (n, s, s, 3), dtype=torch.uint8,
                                 generator=g),
          "embedding": torch.randn(n, 17, 768, generator=g),
          "max_len": torch.randint(3, 18, (n, 1), generator=g).float(),
          "sentence_embedding": torch.randn(n, 768, generator=g),
          "z": torch.randn(n, cfg.z_dim, generator=g)}


def _port(cfg, w):
  from xmcgan_image_generation_tpu_torch.engine.state import (
      TrainState,
      create_optimizers,
  )
  from xmcgan_image_generation_tpu_torch.models import get_architecture
  from xmcgan_image_generation_tpu_torch.utils import pretrained

  gen_cls, disc_cls = get_architecture(cfg)
  g = gen_cls(cfg, device="meta")
  g.load_state_dict({k: v.clone() for k, v in w["g"].items()}, assign=True)
  d = disc_cls(cfg, device="meta")
  d.load_state_dict({k: v.clone() for k, v in w["d"].items()}, assign=True)
  g_opt, d_opt = create_optimizers(cfg, g, d)
  state = TrainState(step=0, generator=g, discriminator=d, g_opt=g_opt,
                     d_opt=d_opt, ema_params={n: p.detach().clone()
                                              for n, p in g.named_parameters()})
  extra = {}
  if cfg.pretrained_image_contrastive:
    tower = pretrained.get_pretrained_model(device="meta",
                                            dtype=torch.float32)
    tower.load_state_dict(w["tower"], assign=True)
    extra["image_model"] = tower
  return state, extra


def _rel(a, b):
  return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("fused, pretrained, accum, size", [
    (False, False, 1, 32), (True, True, 1, 32), (True, False, 2, 64)],
    ids=["plain-32", "fused-tower-32", "fused-accum2-64"])
def test_one_outer_step(fused, pretrained, accum, size):
  from xmcgan_image_generation_tpu_torch.engine.step import train_step

  torch.manual_seed(0)
  cfg = _config(scale_fused_convs=fused, pretrained_image_contrastive=pretrained,
                grad_accum_steps=accum, image_size=size)
  spec = ref.spec(dict(cfg))
  w = {net: weights.draw(spec[net], SEED, net, "cpu") for net in spec}
  state, extra = _port(cfg, w)
  batch = _batch(cfg)
  _, metrics = train_step(state, batch, cfg, extra)
  rs = ref.new_state(dict(cfg), w["g"], w["d"], w["tower"],
                     ref.trained(spec["g"]), ref.trained(spec["d"]))
  values = ref.outer_step(rs, batch, dict(cfg))
  for name in ref.LOSSES:
    assert float(metrics[name]) == pytest.approx(float(values[name]),
                                                 rel=1e-5, abs=1e-6)
  # Adam moves an element by up to its rate whatever the size of its
  # gradient, so an element whose gradient is nought to rounding (a conv
  # bias ahead of a BatchNorm) moves either way on either side: elements
  # agree within two rates, and each moving leaf's change by its norm.
  w0 = {net: weights.draw(spec[net], SEED, net, "cpu") for net in spec}
  for net, module, opt, ref_opt, lr in (
      ("g", state.generator, state.g_opt, rs.g_opt, cfg.g_lr),
      ("d", state.discriminator, state.d_opt, rs.d_opt, cfg.d_lr)):
    m_ref = compare.norms(ref_opt.m)
    keep = compare.moved(m_ref)
    if net == "g":   # G's conv biases ahead of its BatchNorms
      assert len(keep) < len(m_ref)
    floor = max(m_ref.values())
    v_floor = max(float(v.abs().max()) for v in ref_opt.v.values())
    prog_change, ref_change = {}, {}
    for name, p in module.named_parameters():
      m = opt.state[p]["exp_avg"]
      assert float((m - ref_opt.m[name]).abs().max()) <= 1e-4 * floor, name
      assert float((opt.state[p]["exp_avg_sq"] - ref_opt.v[name]).abs().max()
                   ) <= 1e-4 * v_floor, name
      mine = getattr(rs, net)[name]
      assert float((p.detach() - mine).abs().max()) <= 2.01 * lr, name
      prog_change[name] = float((p.detach() - w0[net][name]).norm())
      ref_change[name] = float((mine - w0[net][name]).norm())
    assert compare.gap_of_norms(prog_change, ref_change, keep) < 1e-3
    for name, b in module.named_buffers():
      assert _rel(b, getattr(rs, net)[name]) < 1e-4, name
  for name, p in state.ema_params.items():
    assert float((p - rs.ema[name]).abs().max()) <= 2.01 * cfg.g_lr, name


def test_serving_generator():
  from xmcgan_image_generation_tpu_torch.models import get_architecture
  from xmcgan_image_generation_tpu_torch.utils.serving import (
      ServingGenerator,
  )

  cfg = _config(scale_fused_convs=True)
  spec = ref.spec(dict(cfg))["g"]
  g_w = weights.draw(spec, SEED, "g", "cpu")
  gen = torch.Generator().manual_seed(5)
  inputs = {"sentence_embedding": torch.randn(3, 768, generator=gen),
            "embedding": torch.randn(3, 17, 768, generator=gen),
            "max_len": torch.tensor([[3.0], [17.0], [9.0]]),
            "z": torch.randn(3, cfg.z_dim, generator=gen)}
  g_w.update(ref.batch_statistics(g_w, dict(cfg), inputs))
  g = get_architecture(cfg)[0](cfg, device="meta")
  g.load_state_dict({k: v.clone() for k, v in g_w.items()}, assign=True)
  serve = ServingGenerator(cfg, g, {n: p.detach() for n, p in
                                    g.named_parameters()})
  with torch.no_grad():
    got = serve(*[inputs[k] for k in ("sentence_embedding", "embedding",
                                      "max_len", "z")])
  want = ref.generate(g_w, dict(cfg), inputs)
  assert float((got - want).abs().max()) < 1e-5
  # Calibrated statistics: the images are not saturated.
  assert 0.02 < float(want.std()) and float((want - 0.5).abs().max()) < 0.5


def test_batch_statistics_are_the_batchs():
  cfg = dict(_config(scale_fused_convs=True))
  spec = ref.spec(cfg)["g"]
  g_w = weights.draw(spec, SEED, "g", "cpu")
  gen = torch.Generator().manual_seed(6)
  inputs = {"sentence_embedding": torch.randn(8, 768, generator=gen),
            "embedding": torch.randn(8, 17, 768, generator=gen),
            "max_len": torch.full((8, 1), 17.0),
            "z": torch.randn(8, cfg["z_dim"], generator=gen)}
  stats = ref.batch_statistics(g_w, cfg, inputs)
  assert set(stats) == {n for n in spec if n.endswith((".mean", ".var"))}
  g_w.update(stats)
  # With its statistics the eval-mode forward is the training-mode one.
  train = layers.Tree(dict(g_w))
  with torch.no_grad():
    want = ref.nets.generator(layers.Scope(train), cfg, inputs, inputs["z"],
                              training=True)
  assert float((ref.generate(g_w, cfg, inputs) - want).abs().max()) < 1e-4


@pytest.mark.parametrize("op", ["up", "pool"])
def test_scale_fused_convs_are_the_plain_ones(op):
  """The reference's one-convolution forms against upsample + conv3x3 and
  conv3x3 + avgpool, in float64."""
  gen = torch.Generator().manual_seed(1)
  x = torch.randn(2, 5, 6, 8, generator=gen, dtype=torch.float64)
  w = torch.randn(4, 5, 3, 3, generator=gen, dtype=torch.float64)
  tree = layers.Tree({"kernel": w, "bias": torch.zeros(4, dtype=torch.float64)})
  got = layers.conv(layers.Scope(tree), x, 5, 4, 3, scale_op=op)
  if op == "up":
    want = F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), w,
                    padding=1)
  else:
    want = F.avg_pool2d(F.conv2d(x, w, padding=1), 2)
  assert float((got - want).abs().max()) < 1e-12


def test_the_cells_configurations_are_covered():
  for name in ("coco_xmc", "coco_xmc_256"):
    cfg = cells.config(name)["config"]
    ref.nets.check_config(cfg)
    spec = ref.spec(cfg)
    assert len(ref.trained(spec["g"])) > 50 and len(ref.trained(spec["d"])) > 30

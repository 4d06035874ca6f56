"""XMC-GAN's training step in the reference: the critic and joint updates,
Adam and the EMA (the published update rules; arXiv 2101.04702, and
google-research/xmcgan_image_generation ``xmcgan/xmc_gan.py``).

An outer step takes a super-batch of ``d_step_per_g_step`` sub-batches:
``d_step_per_g_step - 1`` critic updates of D, then one joint update of G
and D on the last.  The joint update runs G once and D once on ``concat(real,
fake)``; the gradients of D's loss with respect to D and of G's loss with
respect to G are two pulls through that one graph.  With
``grad_accum_steps = k`` each update takes its gradients over k contiguous
microbatches in turn, each with its own batch statistics and contrastive
pools, and steps Adam once on their mean; what a microbatch's forward
writes (BatchNorm running averages, D's ``u0``) the next one reads.  The
critic update runs G in training mode and writes none of G's state.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List

import torch

from benchmark.reference import layers, nets
from benchmark.reference.layers import Scope, Tree

Tensor = torch.Tensor
LOSSES = ("d_loss", "g_loss", "c_loss_d", "c_loss_g", "c_loss_g_pretrained")


@contextlib.contextmanager
def float32() -> Iterator[None]:
  """Products and convolutions in float32 proper: TF32 off."""
  flags = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


@dataclasses.dataclass
class Adam:
  """Adam with bias correction (eps outside the square root), over the
  tensors of a tree that are trained."""
  lr: float
  b1: float
  b2: float
  eps: float = 1e-8
  count: int = 0
  m: Dict[str, Tensor] = dataclasses.field(default_factory=dict)
  v: Dict[str, Tensor] = dataclasses.field(default_factory=dict)

  def apply(self, params: Dict[str, Tensor], grads: Dict[str, Tensor]):
    self.count += 1
    c1 = 1 - self.b1 ** self.count
    c2 = 1 - self.b2 ** self.count
    with torch.no_grad():
      for name, g in grads.items():
        m = self.m.get(name, torch.zeros_like(g))
        v = self.v.get(name, torch.zeros_like(g))
        self.m[name] = m = self.b1 * m + (1 - self.b1) * g
        self.v[name] = v = self.b2 * v + (1 - self.b2) * g * g
        params[name] = params[name] - (self.lr / c1) * m / (
            torch.sqrt(v) / c2 ** 0.5 + self.eps)


@dataclasses.dataclass
class State:
  """What the step carries from update to update."""
  g: Dict[str, Tensor]        # G's parameters and BatchNorm statistics
  d: Dict[str, Tensor]        # D's parameters and u0
  tower: Dict[str, Tensor]    # the frozen ResNet-50
  g_params: List[str]         # the names in `g` that are trained
  d_params: List[str]
  g_opt: Adam
  d_opt: Adam
  ema: Dict[str, Tensor]
  step: int = 0


def new_state(cfg, g: Dict[str, Tensor], d: Dict[str, Tensor],
              tower: Dict[str, Tensor], g_params, d_params) -> State:
  """Fresh optimizers, the EMA a copy of G's parameters."""
  nets.check_config(cfg)

  def adam(lr):
    return Adam(lr=lr, b1=cfg["beta1"], b2=cfg["beta2"])

  return State(g=dict(g), d=dict(d), tower=tower, g_params=list(g_params),
               d_params=list(d_params), g_opt=adam(cfg["g_lr"]),
               d_opt=adam(cfg["d_lr"]),
               ema={n: g[n].clone() for n in g_params})


def _cond(batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
  return {k: batch[k] for k in ("sentence_embedding", "embedding",
                                "max_len")}


def _real(batch: Dict[str, Tensor]) -> Tensor:
  return batch["image"].float() / 255.0


def _trainable(tree: Tree, names) -> List[Tensor]:
  out = []
  for n in names:
    tree.tensors[n] = tree.tensors[n].detach().requires_grad_(True)
    out.append(tree.tensors[n])
  return out


def _critic(state: State, batch, cfg, rounding, remat):
  g_tree = Tree(state.g, rounding=rounding, remat=remat)
  g_tree.recording = False     # the critic writes none of G's state
  d_tree = Tree(dict(state.d), rounding=rounding, remat=remat)
  d_vars = _trainable(d_tree, state.d_params)
  with torch.no_grad():
    fake = nets.generator(Scope(g_tree), cfg, _cond(batch), batch["z"],
                          training=True)
  logit, heads = nets.discriminator(
      Scope(d_tree), cfg, torch.cat([_real(batch), fake]), _cond(batch),
      critic_only=True)
  d_tree.recording = False
  real_logit, fake_logit = logit.chunk(2)
  d_loss = (layers.hinge_d(real_logit, fake_logit)
            + heads["real_word"] + heads["real_sentence"])
  grads = torch.autograd.grad(d_loss, d_vars)
  return {"d": grads}, {}, {"d": d_tree.updates}


def _joint(state: State, batch, cfg, rounding, remat):
  g_tree = Tree(dict(state.g), rounding=rounding, remat=remat)
  d_tree = Tree(dict(state.d), rounding=rounding, remat=remat)
  t_tree = Tree(state.tower, rounding=rounding, remat=remat)
  t_tree.recording = False
  g_vars = _trainable(g_tree, state.g_params)
  d_vars = _trainable(d_tree, state.d_params)
  real = _real(batch)
  fake = nets.generator(Scope(g_tree), cfg, _cond(batch), batch["z"],
                        training=True)
  logit, heads = nets.discriminator(Scope(d_tree), cfg,
                                    torch.cat([real, fake]), _cond(batch))
  g_tree.recording = d_tree.recording = False
  real_logit, fake_logit = logit.chunk(2)
  c_loss_d = heads["real_word"] + heads["real_sentence"]
  c_loss_g = heads["fake_word"] + heads["fake_sentence"] + heads["image"]
  pretrained = torch.zeros((), device=logit.device)
  if cfg["pretrained_image_contrastive"]:
    tower = Scope(t_tree)
    with torch.no_grad():
      real_out = nets.resnet50(tower, real)
    pretrained = layers.nt_xent(tower, real_out, nets.resnet50(tower, fake))
  d_loss = layers.hinge_d(real_logit, fake_logit) + c_loss_d
  g_loss = layers.hinge_g(fake_logit) + c_loss_g + pretrained
  d_grads = torch.autograd.grad(d_loss, d_vars, retain_graph=True)
  g_grads = torch.autograd.grad(g_loss, g_vars)
  values = dict(d_loss=d_loss, g_loss=g_loss, c_loss_d=c_loss_d,
                c_loss_g=c_loss_g, c_loss_g_pretrained=pretrained)
  return ({"d": d_grads, "g": g_grads},
          {k: v.detach() for k, v in values.items()},
          {"g": g_tree.updates, "d": d_tree.updates})


def _update(state: State, fn, batch, cfg, rounding, remat):
  """Mean gradients and losses of ``fn`` over the microbatches; each
  microbatch's writes land before the next one runs."""
  k = int(cfg["grad_accum_steps"])
  rows = next(iter(batch.values())).shape[0] // k
  grad_sums, loss_sums = {}, {}
  for i in range(k):
    micro = {n: x[i * rows:(i + 1) * rows] for n, x in batch.items()}
    grads, values, updates = fn(state, micro, cfg, rounding, remat)
    for net, gs in grads.items():
      sums = grad_sums.setdefault(net, [torch.zeros_like(g) for g in gs])
      for total, g in zip(sums, gs):
        total.add_(g)
    for name, v in values.items():
      loss_sums[name] = loss_sums.get(name, 0.0) + v
    for net, ups in updates.items():
      getattr(state, net).update(ups)
  return ({net: [g / k for g in gs] for net, gs in grad_sums.items()},
          {name: v / k for name, v in loss_sums.items()})


def outer_step(state: State, superbatch: Dict[str, Tensor], cfg,
               rounding=None, remat: bool = False) -> Dict[str, Tensor]:
  """One outer step on ``superbatch``; updates ``state`` and returns the
  joint update's five losses (scalar tensors)."""
  n = int(cfg["d_step_per_g_step"])
  rows = next(iter(superbatch.values())).shape[0] // n
  subs = [{k: x[i * rows:(i + 1) * rows] for k, x in superbatch.items()}
          for i in range(n)]
  with float32():
    for sub in subs[:-1]:
      grads, _ = _update(state, _critic, sub, cfg, rounding, remat)
      state.d_opt.apply(state.d, dict(zip(state.d_params, grads["d"])))
    grads, values = _update(state, _joint, subs[-1], cfg, rounding, remat)
  state.d_opt.apply(state.d, dict(zip(state.d_params, grads["d"])))
  state.g_opt.apply(state.g, dict(zip(state.g_params, grads["g"])))
  decay = cfg["polyak_decay"]
  with torch.no_grad():
    for name in state.g_params:
      state.ema[name] = decay * state.ema[name] + (1 - decay) * state.g[name]
  state.step += 1
  return {name: values[name] for name in LOSSES}


def spec(cfg) -> Dict[str, Dict]:
  """``{"g", "d", "tower"}``: each network's tensors as ``name -> (shape,
  draw)`` and the names of its trained parameters, from a forward on
  ``meta`` tensors at batch 2."""
  nets.check_config(cfg)
  s, z = cfg["image_size"], cfg["z_dim"]
  cond = {"sentence_embedding": torch.zeros(2, nets.BERT_DIM, device="meta"),
          "embedding": torch.zeros(2, nets.TEXT_LEN, nets.BERT_DIM,
                                   device="meta"),
          "max_len": torch.zeros(2, 1, device="meta")}
  out = {}
  g = Tree()
  nets.generator(Scope(g), cfg, cond, torch.zeros(2, z, device="meta"),
                 training=True)
  d = Tree()
  nets.discriminator(Scope(d), cfg, torch.zeros(4, s, s, 3, device="meta"),
                     cond)
  t = Tree()
  nets.resnet50(Scope(t), torch.zeros(2, s, s, 3, device="meta"))
  for name, tree in (("g", g), ("d", d), ("tower", t)):
    out[name] = tree.spec
  return out


def trained(spec_of_net: Dict) -> List[str]:
  """The names of a network's trained parameters: every tensor but the
  BatchNorm statistics and ``u0``."""
  return [n for n, (_, draw) in spec_of_net.items()
          if draw[0] not in ("zeros", "ones", "u0")]


def generate(g: Dict[str, Tensor], cfg, inputs: Dict[str, Tensor],
             rounding=None) -> Tensor:
  """G in eval mode (BatchNorm with its running averages): images
  ``[B, S, S, 3]`` in ``[0, 1]``."""
  tree = Tree(g, rounding=rounding)
  tree.recording = False
  with torch.no_grad(), float32():
    return nets.generator(Scope(tree), cfg, _cond(inputs), inputs["z"],
                          training=False)


def batch_statistics(g: Dict[str, Tensor], cfg, inputs: Dict[str, Tensor]
                     ) -> Dict[str, Tensor]:
  """G's BatchNorm statistics as the running averages of a G trained to
  convergence on ``inputs`` would hold them: each norm's batch mean and
  variance in a training-mode forward."""
  tree = Tree(g)
  with torch.no_grad(), float32():
    nets.generator(Scope(tree), cfg, _cond(inputs), inputs["z"],
                   training=True)
  out = {}
  for name, value in tree.updates.items():
    old = g[name]
    # The recorded value is 0.9 old + 0.1 batch: take the batch's part.
    out[name] = (value - layers.BN_MOMENTUM * old) / (1 - layers.BN_MOMENTUM)
  return out

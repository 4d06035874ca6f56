"""Batched on-card BERT caption embedding (the JAX package's
``data/bert_embed.py``).

The replacement for the reference's offline preprocessing pass, which
crawled captions through a TF-Hub Keras BERT one mini-batch at a time
(reference preprocess_data.py:29-75).  `BertModel` is BERT's encoder in
plain PyTorch, as HuggingFace's ``FlaxBertModel`` computes it in float32:
word, position and token-type-0 embeddings and a LayerNorm, then
``num_hidden_layers`` layers of self-attention (masked keys get
``finfo(float32).min`` added, so an all-masked row attends uniformly and
stays finite), dense, residual and LayerNorm, then intermediate, the exact
(erf) GELU, output, residual and LayerNorm; dropout is off and there is no
pooler.  Its products are plain ``torch`` matrix products in float32 (with
TF32 off, PyTorch's default for matrix products).

Weights come from a local HuggingFace directory, the one that
``FlaxBertModel.from_pretrained(path)`` reads (``config.json`` and
``flax_model.msgpack``, decoded by the port's own msgpack reader), without
``transformers`` or ``flax``.  Without one, a BERT-base of ``BertConfig()``'s
geometry with HuggingFace's initialization, drawn from a seeded
``torch.Generator``, stands in (for tests and smoke runs: its embeddings
are placeholders, not semantic, and not the JAX package's random ones).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from xmcgan_image_generation_tpu_torch.data.tokenizer import BertTokenizer

log = logging.getLogger("xmcgan_torch")

BERT_DIM = 768
SEED = 0   # of the random BERT-base that stands in without weights


@dataclasses.dataclass(frozen=True)
class BertConfig:
  """The geometry of ``transformers.BertConfig()`` (bert-base-uncased)."""
  vocab_size: int = 30522
  hidden_size: int = 768
  num_hidden_layers: int = 12
  num_attention_heads: int = 12
  intermediate_size: int = 3072
  hidden_act: str = "gelu"
  max_position_embeddings: int = 512
  type_vocab_size: int = 2
  initializer_range: float = 0.02
  layer_norm_eps: float = 1e-12

  @classmethod
  def from_dict(cls, values: Mapping[str, Any]) -> "BertConfig":
    """The fields of a HuggingFace ``config.json``; raises on an
    activation or a position embedding that `BertModel` does not
    compute."""
    if values.get("hidden_act", "gelu") != "gelu":
      raise ValueError(f"hidden_act={values['hidden_act']!r}: only 'gelu' "
                       f"(the exact erf form) is computed")
    kind = values.get("position_embedding_type", "absolute")
    if kind != "absolute":
      raise ValueError(f"position_embedding_type={kind!r}: only "
                       f"'absolute' is computed")
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in values.items() if k in names})


class BertLayer(nn.Module):
  """One encoder layer (HF's ``FlaxBertLayer``)."""

  def __init__(self, config: BertConfig, device=None):
    super().__init__()
    h, i = config.hidden_size, config.intermediate_size
    self.heads = config.num_attention_heads
    self.query = nn.Linear(h, h, device=device)
    self.key = nn.Linear(h, h, device=device)
    self.value = nn.Linear(h, h, device=device)
    self.attention_output = nn.Linear(h, h, device=device)
    self.attention_norm = nn.LayerNorm(h, config.layer_norm_eps,
                                       device=device)
    self.intermediate = nn.Linear(h, i, device=device)
    self.act = nn.GELU()
    self.output = nn.Linear(i, h, device=device)
    self.output_norm = nn.LayerNorm(h, config.layer_norm_eps, device=device)

  def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    b, l, h = x.shape
    d = h // self.heads

    def split(t):
      return t.view(b, l, self.heads, d).transpose(1, 2)

    # flax's dot_product_attention_weights: the query scaled first.
    q = split(self.query(x)) / math.sqrt(d)
    k, v = split(self.key(x)), split(self.value(x))
    weights = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
    context = (weights @ v).transpose(1, 2).reshape(b, l, h)
    x = self.attention_norm(self.attention_output(context) + x)
    return self.output_norm(self.output(self.act(self.intermediate(x))) + x)


class BertModel(nn.Module):
  """``(ids [B, L], mask [B, L]) -> last_hidden_state [B, L, hidden]``."""

  def __init__(self, config: BertConfig, device=None):
    super().__init__()
    self.config = config
    h = config.hidden_size
    self.word_embeddings = nn.Embedding(config.vocab_size, h, device=device)
    self.position_embeddings = nn.Embedding(config.max_position_embeddings,
                                            h, device=device)
    self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h,
                                              device=device)
    self.embeddings_norm = nn.LayerNorm(h, config.layer_norm_eps,
                                        device=device)
    self.layers = nn.ModuleList(BertLayer(config, device)
                                for _ in range(config.num_hidden_layers))

  def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    x = (self.word_embeddings(ids)
         + self.position_embeddings.weight[:ids.shape[1]]
         + self.token_type_embeddings.weight[0])
    x = self.embeddings_norm(x)
    bias = torch.zeros(mask.shape, dtype=x.dtype, device=x.device)
    bias = bias.masked_fill(mask <= 0, torch.finfo(x.dtype).min)
    bias = bias[:, None, None, :]
    for layer in self.layers:
      x = layer(x, bias)
    return x


def random_bert() -> BertModel:
  """A BERT-base on the CPU with HuggingFace's initialization: weights and
  embeddings normal(0, ``initializer_range``), biases 0, LayerNorms at 1
  and 0; drawn in module order from ``torch.Generator(SEED)``."""
  config = BertConfig()
  model = BertModel(config, device="meta").to_empty(device="cpu")
  gen = torch.Generator().manual_seed(SEED)
  with torch.no_grad():
    for module in model.modules():
      if isinstance(module, (nn.Linear, nn.Embedding)):
        module.weight.normal_(0.0, config.initializer_range, generator=gen)
      if isinstance(module, nn.Linear):
        module.bias.zero_()
      elif isinstance(module, nn.LayerNorm):
        module.weight.fill_(1.0)
        module.bias.zero_()
  return model


def _f32(value) -> torch.Tensor:
  if isinstance(value, torch.Tensor):
    return value.float()
  return torch.from_numpy(np.array(value, np.float32))


def load_flax_bert(params: Mapping[str, Any],
                   config: BertConfig) -> BertModel:
  """A `BertModel` on the CPU holding ``FlaxBertModel``'s parameters.

  ``params`` is the Flax tree (numpy arrays or tensors):
  ``embeddings/{word,position,token_type}_embeddings/embedding``,
  ``embeddings/LayerNorm/{scale,bias}`` and, for each layer ``i``,
  ``encoder/layer/{i}/attention/self/{query,key,value}``,
  ``attention/output/{dense,LayerNorm}``, ``intermediate/dense`` and
  ``output/{dense,LayerNorm}``; a tree under ``bert`` (a checkpoint of a
  model with heads) is read from there, the pooler and heads are not.
  Flax kernels are ``[in, out]``, so they are transposed into
  ``nn.Linear.weight``."""
  if "embeddings" not in params and "bert" in params:
    params = params["bert"]
  emb, layers = params["embeddings"], params["encoder"]["layer"]
  if len(layers) != config.num_hidden_layers:
    raise ValueError(f"{len(layers)} encoder layers in the parameters, "
                     f"{config.num_hidden_layers} in the configuration")
  state: Dict[str, torch.Tensor] = {}

  def dense(name, tree):
    state[f"{name}.weight"] = _f32(tree["kernel"]).T.contiguous()
    state[f"{name}.bias"] = _f32(tree["bias"])

  def norm(name, tree):
    state[f"{name}.weight"] = _f32(tree["scale"])
    state[f"{name}.bias"] = _f32(tree["bias"])

  for kind in ("word", "position", "token_type"):
    state[f"{kind}_embeddings.weight"] = _f32(
        emb[f"{kind}_embeddings"]["embedding"])
  norm("embeddings_norm", emb["LayerNorm"])
  for i in range(config.num_hidden_layers):
    tree, name = layers[str(i)], f"layers.{i}"
    for part in ("query", "key", "value"):
      dense(f"{name}.{part}", tree["attention"]["self"][part])
    dense(f"{name}.attention_output", tree["attention"]["output"]["dense"])
    norm(f"{name}.attention_norm", tree["attention"]["output"]["LayerNorm"])
    dense(f"{name}.intermediate", tree["intermediate"]["dense"])
    dense(f"{name}.output", tree["output"]["dense"])
    norm(f"{name}.output_norm", tree["output"]["LayerNorm"])
  model = BertModel(config, device="meta")
  model.load_state_dict(state, strict=True, assign=True)
  return model


def load_pretrained(model_path: str) -> BertModel:
  """The `BertModel` of a HuggingFace directory's ``config.json`` and
  ``flax_model.msgpack``."""
  # Imported here: the bridge pulls in the training state's modules.
  from xmcgan_image_generation_tpu_torch.utils import reference_bridge

  with open(os.path.join(model_path, "config.json")) as f:
    config = BertConfig.from_dict(json.load(f))
  weights = os.path.join(model_path, "flax_model.msgpack")
  if not os.path.isfile(weights):
    raise FileNotFoundError(
        f"{model_path}: no flax_model.msgpack (the port reads the weights "
        f"that FlaxBertModel.from_pretrained reads)")
  with open(weights, "rb") as f:
    params = reference_bridge.msgpack_restore(f.read())
  return load_flax_bert(params, config)


def build_bert(model_path: Optional[str] = None, device="cuda"
               ) -> Callable[[Any, Any], torch.Tensor]:
  """Returns ``(ids [B, L], mask [B, L]) -> [B, L, hidden]``, a float32
  tensor on ``device``: the weights of the HuggingFace directory
  ``model_path``, or a random BERT-base (`random_bert`) without one."""
  # Imported here: serving pulls in the generator's modules.
  from xmcgan_image_generation_tpu_torch.utils.serving import check_device

  device = check_device(device)
  if model_path:
    model = load_pretrained(model_path)
    log.info("Loaded BERT from %s", model_path)
  else:
    log.warning(
        "No BERT path given: using a RANDOM-initialized bert-base. "
        "Embeddings are placeholders, not semantic.")
    model = random_bert()
  model = model.to(device).eval()

  def embed(ids, mask) -> torch.Tensor:
    with torch.inference_mode():
      return model(torch.as_tensor(ids).to(device, torch.long),
                   torch.as_tensor(mask).to(device))

  return embed


class CaptionEmbedder:
  """Tokenizes and embeds caption batches with fixed shapes.

  One call handles ``[n_captions]`` strings; it pads the last chunk to a
  full batch with all-zero rows (ids and mask), as the JAX package does
  so that its jitted BERT compiles once.  ``seconds`` adds up the host's
  time to tokenize and the time to embed (to the embeddings on the host).
  """

  def __init__(self, tokenizer: BertTokenizer,
               embed_fn: Callable,
               max_text_length: int = 17,
               batch_size: int = 256):
    self.tokenizer = tokenizer
    self.embed_fn = embed_fn
    self.max_text_length = max_text_length
    self.batch_size = batch_size
    self.seconds = {"tokenize": 0.0, "embed": 0.0}

  def __call__(self, captions: Sequence[str]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns ``(embeddings [n, L, 768], max_len [n])``."""
    t0 = time.perf_counter()
    n = len(captions)
    ids = np.zeros((n, self.max_text_length), np.int32)
    lengths = np.zeros((n,), np.int64)
    for i, text in enumerate(captions):
      row, true_len = self.tokenizer.encode(text, self.max_text_length)
      ids[i] = row
      lengths[i] = true_len
    # The attention mask covers the true tokens only, as the reference's
    # (preprocess_data.py:44-48); BERT still emits vectors at padded
    # positions, which are stored and masked downstream through max_len.
    attn = (np.arange(self.max_text_length)[None, :]
            < lengths[:, None]).astype(np.int32)
    t1 = time.perf_counter()
    embeddings = np.zeros((n, self.max_text_length, BERT_DIM), np.float32)
    for start in range(0, n, self.batch_size):
      chunk = ids[start:start + self.batch_size]
      mask = attn[start:start + self.batch_size]
      pad = self.batch_size - chunk.shape[0]
      if pad:
        zeros = np.zeros((pad, self.max_text_length), np.int32)
        chunk = np.concatenate([chunk, zeros])
        mask = np.concatenate([mask, zeros])
      out = self.embed_fn(torch.from_numpy(chunk), torch.from_numpy(mask))
      out = torch.as_tensor(out).cpu().numpy()
      embeddings[start:start + self.batch_size] = out[:self.batch_size
                                                      - pad]
    self.seconds["tokenize"] += t1 - t0
    self.seconds["embed"] += time.perf_counter() - t1
    return embeddings, lengths

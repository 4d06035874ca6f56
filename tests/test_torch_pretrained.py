"""The port's frozen ResNet-50 tower against the JAX package's: the resize
to 224, the ``.npy`` loader, and the tower's contrastive term at 256 px.

The checkpoints are made here from the JAX tower's own initialization,
with a random head (flax starts it at zero, which would hide the logits)
and non-trivial running statistics, and written as a JAX user writes
them (``np.save`` of a ``{"params", "batch_stats"}`` dict): in the JAX
package's flat ``stage{i}_block{j}`` layout and in the reference's
nested ``stage{i}/block{j}``, with numpy leaves, ``jax.Array`` leaves and
``jax.Array`` leaves under flax ``FrozenDict``s.

Tolerances.  The resize: 1e-5 absolute on images in [0, 1] (float32, the
two filters sum their taps in other orders; the unantialiased resize the
port had missed by 0.20 at 256 -> 224).  The tower in float32: 1e-4, as
``tests/test_reference_bridge.py`` holds the JAX tower to the reference
(XLA:CPU and PyTorch's convs sum in other orders through 53 layers).
The NT-Xent of the tower's logits: 1e-5 absolute on a loss of order 1.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmcgan_image_generation_tpu.engine import xmc_gan as j_xmc_gan
from xmcgan_image_generation_tpu.utils import pretrained as j_pretrained
from xmcgan_image_generation_tpu_torch.engine import xmc_gan
from xmcgan_image_generation_tpu_torch.utils import pretrained

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-4


def _images(size, seed, n=2):
  return np.random.default_rng(seed).uniform(
      0, 1, (n, size, size, 3)).astype(np.float32)


def _identity_tower(images):
  """A tower that hands back the images it is given."""
  return images, images


@pytest.mark.parametrize("size", [256, 128])
def test_resize_matches_jax(size):
  """256 -> 224 (the paper's 256 px configuration) shrinks and must
  antialias; 128 -> 224 (the flagship) grows."""
  x = _images(size, seed=size)
  want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 224, 224, 3),
                                     "bilinear"))
  _, got = pretrained.get_pretrained_embs(_identity_tower,
                                          torch.from_numpy(x))
  assert got.shape == (2, 224, 224, 3)
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _nested(tree):
  """The flat ``stage{i}_block{j}`` layout as the reference's nesting."""
  out = {}
  for key, value in tree.items():
    stage, sep, block = key.partition("_")
    if sep and block.startswith("block"):
      out.setdefault(stage, {})[block] = value
    else:
      out[key] = value
  return out


def _write(path, variables, layout, leaves):
  tree = {c: (_nested(v) if layout == "nested" else v)
          for c, v in variables.items()}
  if leaves != "numpy":
    tree = jax.tree_util.tree_map(jnp.asarray, tree)
  if leaves == "frozen":
    tree = {c: flax.core.freeze(v) for c, v in tree.items()}
  np.save(path, tree, allow_pickle=True)
  return str(path)


@pytest.fixture(scope="module")
def tower(tmp_path_factory):
  """The JAX tower's initialization with a random head and running
  statistics, written in every layout; JAX's own load of the nested
  ``jax.Array`` file, and its outputs on 224 and 256 px images."""
  _, state = j_pretrained.get_pretrained_model(dtype=jnp.float32)
  variables = jax.device_get({"params": flax.core.unfreeze(state.params),
                              "batch_stats": flax.core.unfreeze(
                                  state.batch_stats)})
  rng = np.random.default_rng(0)
  head = variables["params"]["head"]
  head["kernel"] = (rng.standard_normal(head["kernel"].shape)
                    * 0.05).astype(np.float32)
  head["bias"] = rng.standard_normal(head["bias"].shape).astype(np.float32)
  variables["batch_stats"] = jax.tree_util.tree_map(
      lambda v: (v * rng.uniform(0.5, 1.5, v.shape)
                 + rng.uniform(-0.1, 0.1, v.shape)).astype(np.float32),
      variables["batch_stats"])
  root = tmp_path_factory.mktemp("tower")
  paths = {(layout, leaves): _write(root / f"{layout}_{leaves}.npy",
                                    variables, layout, leaves)
           for layout in ("flat", "nested")
           for leaves in ("numpy", "jax", "frozen")}
  j_model, j_state = j_pretrained.get_pretrained_model(
      "resnet50", paths[("nested", "jax")], dtype=jnp.float32)
  embs = jax.jit(lambda s, x: j_pretrained.get_pretrained_embs(
      s, j_model, x))
  images = _images(224, seed=1)
  pool, out = embs(j_state, images)
  real, fake = _images(256, seed=2), _images(256, seed=3)
  additional = {"image_model": j_model, "image_model_state": j_state}
  loss = jax.jit(lambda r, f: j_xmc_gan.pretrained_contrastive(
      additional, r, f))(real, fake)
  return dict(variables=variables, paths=paths, root=root, images=images,
              pool=np.asarray(pool), out=np.asarray(out), real=real,
              fake=fake, fake_out=np.asarray(embs(j_state, fake)[1]),
              loss=float(loss))


@pytest.mark.parametrize("layout,leaves", [
    ("flat", "numpy"), ("flat", "jax"), ("nested", "numpy"),
    ("nested", "jax"), ("nested", "frozen")])
def test_npy_loader_matches_jax(tower, layout, leaves):
  model = pretrained.get_pretrained_model(
      checkpoint_path=tower["paths"][(layout, leaves)], dtype=torch.float32)
  with torch.no_grad():
    pool, out = pretrained.get_pretrained_embs(
        model, torch.from_numpy(tower["images"]))
  assert pool.shape == (2, 7, 7, 2048) and out.shape == (2, 1000)
  np.testing.assert_allclose(pool.numpy(), tower["pool"], rtol=ATOL,
                             atol=ATOL)
  np.testing.assert_allclose(out.numpy(), tower["out"], rtol=ATOL,
                             atol=ATOL)
  assert np.abs(tower["out"]).max() > 0.1   # the head is not zero


def test_tower_term_at_256_matches_jax(tower):
  """The 256 px configuration's ``c_loss_g_pretrained``: both image sets
  shrink to 224 before the tower."""
  model = pretrained.get_pretrained_model(
      checkpoint_path=tower["paths"][("flat", "numpy")], dtype=torch.float32)
  real, fake = torch.from_numpy(tower["real"]), torch.from_numpy(
      tower["fake"])
  with torch.no_grad():
    fake_out = pretrained.get_pretrained_embs(model, fake)[1]
    loss = xmc_gan.pretrained_contrastive({"image_model": model}, real, fake)
  np.testing.assert_allclose(fake_out.numpy(), tower["fake_out"], rtol=ATOL,
                             atol=ATOL)
  assert abs(float(loss) - tower["loss"]) <= 1e-5, (float(loss),
                                                    tower["loss"])


_NO_JAX = textwrap.dedent("""
    import json, sys
    for name in ("jax", "jaxlib", "flax", "ml_dtypes",
                 "xmcgan_image_generation_tpu"):
      sys.modules[name] = None   # any import of them raises ImportError
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from xmcgan_image_generation_tpu_torch.utils import pretrained
    model = pretrained.get_pretrained_model(checkpoint_path=sys.argv[1],
                                            dtype=torch.float32)
    with torch.no_grad():
      _, out = pretrained.get_pretrained_embs(
          model, torch.from_numpy(np.load(sys.argv[2])))
    np.save(sys.argv[3], out.numpy())
    print(json.dumps(sorted(
        m for m in sys.modules if m.split(".")[0] in
        ("jax", "jaxlib", "flax", "xmcgan_image_generation_tpu")
        and sys.modules[m] is not None)))
""")


def test_npy_loader_without_jax(tower):
  """A file of ``jax.Array`` leaves under ``FrozenDict``s loads where
  ``jax`` and ``flax`` cannot be imported."""
  images = str(tower["root"] / "images.npy")
  out = str(tower["root"] / "out_no_jax.npy")
  np.save(images, tower["images"])
  env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
  env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
  proc = subprocess.run(
      [sys.executable, "-c", _NO_JAX, tower["paths"][("nested", "frozen")],
       images, out], capture_output=True, text=True, timeout=300, env=env,
      check=False)
  assert proc.returncode == 0, proc.stderr[-3000:]
  assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
  np.testing.assert_allclose(np.load(out), tower["out"], rtol=ATOL,
                             atol=ATOL)


def _malformed(variables, fault):
  params = dict(variables["params"])
  if fault == "missing":
    del params["stage2_block1"]
  elif fault == "extra":
    params["stage5_block1"] = params["stage4_block1"]
  else:
    block = dict(params["stage3_block2"])
    block["conv2"] = {"kernel": np.zeros((3, 3, 256, 8), np.float32)}
    params["stage3_block2"] = block
  return {"params": params, "batch_stats": variables["batch_stats"]}


@pytest.mark.parametrize("fault,path", [
    ("missing", "stage2_block1.bn1.bias"),
    ("extra", "stage5_block1.bn1.bias"),
    ("shape", "stage3_block2.conv2.kernel")])
def test_malformed_tree_names_the_path(tower, tmp_path, fault, path):
  name = _write(tmp_path / "bad.npy", _malformed(tower["variables"], fault),
                "flat", "numpy")
  with pytest.raises(ValueError, match=rf"bad\.npy.*{fault}.*{path}"):
    pretrained.get_pretrained_model(checkpoint_path=name,
                                    dtype=torch.float32)


def test_other_classes_are_refused(tmp_path):
  """Unpickling runs what the file names: only arrays and dicts load."""
  import collections

  path = str(tmp_path / "other.npy")
  np.save(path, {"params": collections.OrderedDict(), "batch_stats": {}},
          allow_pickle=True)
  with pytest.raises(ValueError, match="collections.OrderedDict is not "
                                       "allowed"):
    pretrained.load_npy_tree(path)
  with open(str(tmp_path / "plain.npy"), "wb") as f:
    np.save(f, np.zeros(3, np.float32))
  with pytest.raises(ValueError, match="not a pickled dict"):
    pretrained.load_npy_tree(str(tmp_path / "plain.npy"))

"""The port runs where JAX is not installed, as on the machine with the
card, and imports nothing of the JAX package: in a fresh interpreter
where importing ``jax``, ``flax``, ``optax``, ``ml_collections`` or
``xmcgan_image_generation_tpu`` fails, import every module of the port and
``chip_smoke.py``, write a two-shard TFRecord dataset (and a validation
shard) with the port's writer, and take one tiny CPU step through
``train.train`` on it, the host helper and the PNG decoder included.  And
``chip_smoke.py`` refuses to run without a card."""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]

_BLOCKED = ("jax", "flax", "optax", "ml_collections",
            "xmcgan_image_generation_tpu")

_SCRIPT = textwrap.dedent("""
    import importlib, importlib.util, json, os, pkgutil, sys
    BLOCKED = %r
    for name in BLOCKED:
      sys.modules[name] = None   # any import of them raises ImportError
    import torch
    torch.set_num_threads(1)
    import xmcgan_image_generation_tpu_torch as port
    modules = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                     port.__name__ + ".")]
    for name in modules:
      importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    import numpy as np
    from xmcgan_image_generation_tpu_torch import train
    from xmcgan_image_generation_tpu_torch.configs import coco_xmc
    from xmcgan_image_generation_tpu_torch.data import records
    from xmcgan_image_generation_tpu_torch.utils import image_utils
    data_dir = os.path.join(sys.argv[1], "data")
    os.makedirs(data_dir)
    rng = np.random.default_rng(0)
    for name, shards in (("train", 2), ("validation", 1)):
      for s in range(shards):
        path = os.path.join(data_dir, f"coco2014_{name}.tfrecord-{s}")
        with records.TFRecordWriter(path) as w:
          for i in range(3):
            image = rng.integers(0, 256, (40 + i, 36, 3), dtype=np.uint8)
            w.write(records.build_example({
                "image": image_utils.encode_png(image),
                "caption/embedding": rng.standard_normal(
                    5 * 17 * 768).astype(np.float32),
                "caption/max_len": np.array([3, 5, 17, 4, 9], np.int64),
                "caption/text": [b"a caption"] * 5}))
    config = coco_xmc.get_test_config()
    config.update(num_train_steps=1, data_source="tfrecord",
                  data_dir=data_dir)
    config.scale_fused_convs = True
    config.use_pallas = True
    state = train.train(config, sys.argv[1], "cpu")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in BLOCKED + ("jaxlib",)
                    and sys.modules[m] is not None)
    print(json.dumps({"step": state.step, "loaded": loaded,
                      "modules": modules}))
""" % (_BLOCKED,))


def _env():
  env = dict(os.environ)
  env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
  env["CUDA_VISIBLE_DEVICES"] = ""
  return env


def test_port_trains_without_jax(tmp_path):
  proc = subprocess.run(
      [sys.executable, "-c", _SCRIPT, str(tmp_path),
       str(ROOT / "chip_smoke.py")], capture_output=True,
      text=True, timeout=600, env=_env(), cwd=tmp_path, check=False)
  assert proc.returncode == 0, proc.stderr[-3000:]
  result = json.loads(proc.stdout.strip().splitlines()[-1])
  assert result["step"] == 1 and result["loaded"] == []
  # Every module of the port was imported, the new path's among them.
  for name in ("evaluate", "generate", "main", "models.inception_v3",
               "utils.checkpoint", "utils.eval_metrics", "utils.fid",
               "utils.task_manager", "ops.cuda.word_scores",
               "data.pipeline", "data.prefetch", "data.png", "data.resize",
               "data.records", "data.sources", "utils.preemption"):
    assert f"xmcgan_image_generation_tpu_torch.{name}" in result["modules"]
  lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
  record = json.loads(lines[-1])
  assert record["step"] == 1
  assert {"d_loss", "g_loss", "c_loss_d", "c_loss_g", "c_loss_g_pretrained",
          "seconds"} <= set(record)


def test_chip_smoke_fails_without_a_card(tmp_path):
  proc = subprocess.run(
      [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
      text=True, timeout=300, env=_env(), cwd=tmp_path, check=False)
  assert proc.returncode != 0
  assert '"ok"' not in proc.stdout

"""The port runs where JAX is not installed, as on the machine with the
card, and imports nothing of the JAX package: in a fresh interpreter
where importing ``jax``, ``flax``, ``optax``, ``ml_collections`` or
``xmcgan_image_generation_tpu`` fails, import every module of the port and
``chip_smoke.py``, write a two-shard TFRecord dataset (and a validation
shard) with the port's writer, and take one tiny CPU step through
``train.train`` on it, the host helper and the PNG decoder included, then
a second step in a one-process gloo group, through the collectives of
``parallel/``.  And
``chip_smoke.py`` refuses to run without a card.  The reference-layout
generator (``g_spectral_norm``) takes a step through ``main --mode=train``
there too, then ``--mode=generate`` and ``--mode=export`` on its
checkpoint, and `utils/reference_bridge.py` reads a flax-serialized
checkpoint with ``msgpack`` blocked as well.  ``transformers`` and Pillow
(``PIL``) are blocked too: the caption stage (`run_e2e --smoke`'s
preprocess of PNG sources with a random BERT-base, then training on its
shards) runs without them, and a JPEG source raises an error that names
the file and Pillow."""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]

_BLOCKED = ("jax", "flax", "optax", "ml_collections",
            "xmcgan_image_generation_tpu", "transformers", "PIL")

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
    # A second step in a one-process gloo group: through the collectives.
    import socket
    import torch.distributed as dist
    from xmcgan_image_generation_tpu_torch.parallel import collectives
    with socket.socket() as sock:
      sock.bind(("127.0.0.1", 0))
      port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    config.num_train_steps = 2
    collectives.reset_counts()
    state = train.train(config, sys.argv[1], "cpu")
    calls = sum(c["calls"] for c in collectives.counts().values())
    dist.destroy_process_group()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in BLOCKED + ("jaxlib",)
                    and sys.modules[m] is not None)
    print(json.dumps({"step": state.step, "loaded": loaded,
                      "modules": modules, "collective_calls": calls}))
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
  assert result["step"] == 2 and result["loaded"] == []
  assert result["collective_calls"] > 0
  # Every module of the port was imported, the new path's among them.
  for name in ("evaluate", "generate", "main", "models.inception_v3",
               "utils.checkpoint", "utils.eval_metrics", "utils.fid",
               "utils.task_manager", "ops.cuda.word_scores",
               "data.pipeline", "data.prefetch", "data.png", "data.resize",
               "data.records", "data.sources", "utils.preemption",
               "engine.registry", "utils.tb_writer", "utils.metric_writer",
               "configs.coco_xmc_256", "utils.serving", "utils.pretrained",
               "export_serving", "serving_bench", "parallel.mesh",
               "parallel.context", "parallel.collectives",
               "utils.reference_bridge", "data.tokenizer",
               "data.bert_embed", "preprocess_coco", "run_e2e"):
    assert f"xmcgan_image_generation_tpu_torch.{name}" in result["modules"]
  lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
  record = json.loads(lines[-1])   # the loss line, written after progress
  assert record["step"] == 2
  assert {"d_loss", "g_loss", "c_loss_d", "c_loss_g", "c_loss_g_pretrained",
          "seconds"} <= set(record)


def test_chip_smoke_fails_without_a_card(tmp_path):
  proc = subprocess.run(
      [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
      text=True, timeout=300, env=_env(), cwd=tmp_path, check=False)
  assert proc.returncode != 0
  assert '"ok"' not in proc.stdout


_REFERENCE_SCRIPT = textwrap.dedent("""
    import json, sys
    BLOCKED = %r
    for name in BLOCKED:
      sys.modules[name] = None   # any import of them raises ImportError
    import torch
    torch.set_num_threads(1)
    from xmcgan_image_generation_tpu_torch import main
    from xmcgan_image_generation_tpu_torch.utils import reference_bridge
    for mode in ("train", "generate", "export"):
      main.main(["--workdir", sys.argv[1], "--config=test", "--device=cpu",
                 "--num_train_steps=1", "--data_source=synthetic",
                 "--config.g_spectral_norm=True",
                 "--config.fused_spatial_cond=False", f"--mode={mode}"])
    raw = reference_bridge.load_reference_msgpack(sys.argv[2])
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in BLOCKED + ("jaxlib",)
                    and sys.modules[m] is not None)
    print(json.dumps({"loaded": loaded, "step": raw["step"],
                      "kernel": raw["params"]["kernel"].tolist(),
                      "dtype": str(raw["params"]["kernel"].dtype)}))
""" % (_BLOCKED + ("msgpack",),))


def test_reference_layout_trains_and_loads_without_jax(tmp_path):
  import ast

  import flax.serialization
  import numpy as np
  import torch

  source = (ROOT / "xmcgan_image_generation_tpu_torch" / "utils" /
            "reference_bridge.py").read_text()
  imported = set()
  for node in ast.walk(ast.parse(source)):
    if isinstance(node, ast.Import):
      imported |= {a.name.split(".")[0] for a in node.names}
    elif isinstance(node, ast.ImportFrom):
      imported.add((node.module or "").split(".")[0])
  assert not imported & {"jax", "flax", "msgpack", "jaxlib"}, imported
  blob = tmp_path / "ckpt-5"
  blob.write_bytes(flax.serialization.msgpack_serialize(
      {"step": 5, "params": {"kernel": np.arange(6, dtype=np.float32)
                             .reshape(2, 3)}}))
  proc = subprocess.run(
      [sys.executable, "-c", _REFERENCE_SCRIPT, str(tmp_path / "w"),
       str(blob)], capture_output=True, text=True, timeout=600, env=_env(),
      cwd=tmp_path, check=False)
  assert proc.returncode == 0, proc.stderr[-3000:]
  result = json.loads(proc.stdout.strip().splitlines()[-1])
  assert result["loaded"] == [] and result["step"] == 5
  assert result["kernel"] == [[0, 1, 2], [3, 4, 5]]
  assert result["dtype"] == "torch.float32"
  lines = (tmp_path / "w" / "metrics.jsonl").read_text().splitlines()
  assert json.loads(lines[-1])["step"] == 1
  ckpt = torch.load(tmp_path / "w" / "checkpoints" / "checkpoint_1.pt",
                    weights_only=False)
  g_u0 = [k for k in ckpt["generator"] if k.endswith("u0")]
  assert any(k.startswith("GenSpatialBlock_0.") for k in g_u0)
  assert any((tmp_path / "w" / "samples").iterdir())
  (artifact,) = (tmp_path / "w" / "serving").glob("*.pt2")
  served = torch.export.load(str(artifact)).module()(
      torch.zeros(2, 768), torch.zeros(2, 17, 768), torch.full((2, 1), 5.0),
      torch.zeros(2, 8))
  assert served.shape == (2, 32, 32, 3) and bool(torch.isfinite(
      served).all())


_CAPTION_SCRIPT = textwrap.dedent("""
    import json, os, sys
    BLOCKED = %r
    for name in BLOCKED:
      sys.modules[name] = None   # any import of them raises ImportError
    import torch
    torch.set_num_threads(1)
    from xmcgan_image_generation_tpu_torch import preprocess_coco, run_e2e
    workdir = sys.argv[1]
    run_e2e.main(["--smoke", f"--workdir={workdir}", "--device=cpu",
                  "--phase=preprocess,train"])
    try:
      preprocess_coco.encode_image_png(sys.argv[2])
      error = None
    except RuntimeError as e:
      error = str(e)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in BLOCKED + ("jaxlib",)
                    and sys.modules[m] is not None)
    print(json.dumps({"loaded": loaded, "error": error,
                      "records": sorted(os.listdir(
                          os.path.join(workdir, "records")))}))
""" % (_BLOCKED + ("msgpack",),))


def test_caption_stage_without_jax_or_pillow(tmp_path):
  from PIL import Image

  jpeg = tmp_path / "photo.jpg"
  Image.new("RGB", (8, 6), (200, 30, 40)).save(jpeg)
  proc = subprocess.run(
      [sys.executable, "-c", _CAPTION_SCRIPT, str(tmp_path / "w"),
       str(jpeg)], capture_output=True, text=True, timeout=600, env=_env(),
      cwd=tmp_path, check=False)
  assert proc.returncode == 0, proc.stderr[-3000:]
  result = json.loads(proc.stdout.strip().splitlines()[-1])
  assert result["loaded"] == []
  assert "photo.jpg" in result["error"] and "Pillow" in result["error"]
  assert "coco2014_train.tfrecord-00000-of-00002" in result["records"]
  lines = (tmp_path / "w" / "metrics.jsonl").read_text().splitlines()
  assert json.loads(lines[-1])["step"] == 2

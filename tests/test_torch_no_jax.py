"""The port runs where JAX is not installed, as on the machine with the
card: in a fresh interpreter where importing ``jax``, ``flax``, ``optax``
or ``ml_collections`` fails, import the port and take one tiny CPU step
through ``train.train``.  And ``chip_smoke.py`` refuses to run without a
card."""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = textwrap.dedent("""
    import json, os, sys
    for name in ("jax", "flax", "optax", "ml_collections"):
      sys.modules[name] = None   # any import of them raises ImportError
    import torch
    torch.set_num_threads(1)
    from xmcgan_image_generation_tpu_torch import train
    from xmcgan_image_generation_tpu_torch.configs import coco_xmc
    config = coco_xmc.get_test_config()
    config.num_train_steps = 1
    config.scale_fused_convs = True
    config.use_pallas = True
    state = train.train(config, sys.argv[1], "cpu")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "optax",
                                           "ml_collections", "jaxlib")
                    and sys.modules[m] is not None)
    print(json.dumps({"step": state.step, "loaded": loaded}))
""")


def _env():
  env = dict(os.environ)
  env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
  env["CUDA_VISIBLE_DEVICES"] = ""
  return env


def test_port_trains_without_jax(tmp_path):
  proc = subprocess.run(
      [sys.executable, "-c", _SCRIPT, str(tmp_path)], capture_output=True,
      text=True, timeout=600, env=_env(), cwd=tmp_path, check=False)
  assert proc.returncode == 0, proc.stderr[-3000:]
  result = json.loads(proc.stdout.strip().splitlines()[-1])
  assert result == {"step": 1, "loaded": []}
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

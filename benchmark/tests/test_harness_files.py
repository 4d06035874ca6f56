"""The benchmark's data files: ``BENCHMARK.json`` keeps to its contract and
resolves to the files of ``benchmark/``, a cell, configuration and metric
added as files are picked up without an edit, and the yardstick's counts
(`benchmark.flops`, ``benchmark/kernels/``) are those recorded in PERF.md.
"""

import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark import cells, flops, peaks
from benchmark.kernels import ntxent, word_scores
from benchmark.reference import layers, nets

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def _metrics():
  return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_and_entry_keys():
  assert set(BENCH) == TOP_KEYS
  assert BENCH["paths"] == ["benchmark"]
  assert BENCH["command"] == ["python3", "benchmark/run.py"]
  assert 1 <= BENCH["run_seconds"] <= 51
  for c in BENCH["configs"]:
    assert set(c) == {"name", "source", "file", "reduced", "why"}
  for w in BENCH["workloads"]:
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
  for m in BENCH["end_to_end"]:
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
  for m in BENCH["per_layer"]:
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
  assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
  names = ([c["name"] for c in BENCH["configs"]]
           + [w["name"] for w in BENCH["workloads"]]
           + [m["name"] for m in _metrics()]
           + [w["config"] for w in BENCH["workloads"]]
           + [w["traffic"] for w in BENCH["workloads"]]
           + [k for c in BENCH["configs"] for k in c["reduced"]])
  for name in names:
    assert NAME.match(name), name
  for m in _metrics():
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
  for text in ([w["why"] for w in BENCH["workloads"]]
               + [c["why"] for c in BENCH["configs"]]
               + [c["source"] for c in BENCH["configs"]]
               + [m["layer"] for m in BENCH["per_layer"]]):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
  for group in (BENCH["configs"], BENCH["workloads"], _metrics()):
    assert len({x["name"] for x in group}) == len(group)


def test_bounds_and_sources():
  for m in BENCH["end_to_end"]:
    assert 0.01 <= m["bound"] <= 0.25
    assert m["source"] in ("host_clock", "device_trace")
  assert any(m["name"] == "setup_s" and "workloads" not in m
             for m in BENCH["end_to_end"])
  for m in BENCH["per_layer"]:
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
  e2e = {m["name"] for m in BENCH["end_to_end"]}
  for m in BENCH["per_layer"]:
    assert m["moves"] in e2e
  for m in _metrics():
    if "roofline" in m["name"] or "mfu" in m["name"]:
      assert m["unit"] == "%"


def test_every_cell_resolves_and_reports():
  configs = {c["name"]: c for c in BENCH["configs"]}
  for w in BENCH["workloads"]:
    cell = cells.workload(w["name"])
    assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} == {
        k: w[k] for k in ("config", "traffic", "chips", "why")}
    assert w["config"] in configs and w["chips"] in (1, 4)
    assert cells.mix(w["traffic"])["kind"] in ("train", "serve")
    cells.driver(cells.mix(w["traffic"])["kind"])
    e2e = cells.metrics_of(BENCH, w["name"], traced=False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert cells.metrics_of(BENCH, w["name"], traced=True)
    for m in e2e:
      assert m["name"] != "setup_s" or "workloads" not in m
    assert set(cell["limits"])
  for name, c in configs.items():
    path = ROOT / c["file"]
    assert path.is_file() and path.parent.name == "configs"
    data = json.loads(path.read_text())
    assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
    for key in data["reduced"]:
      assert not re.search(r"(_dim|_rank|_size|width|hidden|heads?)$", key)
  for m in _metrics():
    assert hasattr(cells.reader(m["name"]), "read")
  pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
  assert len(set(pairs)) == len(pairs)
  four = sum(w["chips"] == 4 for w in BENCH["workloads"])
  assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_config_files_hold_the_configuration_as_run():
  from xmcgan_image_generation_tpu_torch.configs import coco_xmc, coco_xmc_256

  for name, module in (("coco_xmc", coco_xmc), ("coco_xmc_256", coco_xmc_256)):
    data = cells.config(name)
    assert set(data["config"]) == set(module.get_config())
    assert cells.port_config(data) == data["config"]
  big = cells.config("coco_xmc_256")["config"]
  assert big["grad_accum_steps"] == 2 and big["image_size"] == 256


def test_added_files_are_picked_up(tmp_path):
  """A new cell, with its own configuration and metric, in a copy of the
  benchmark: only files and ``BENCHMARK.json`` entries are added."""
  shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                  ignore=shutil.ignore_patterns("__pycache__"))
  bench = json.loads(json.dumps(BENCH))
  tiny = cells.config("coco_xmc")
  tiny["config"].update(image_size=32, batch_size=2, df_dim=8, gf_dim=8,
                        z_dim=8, pretrained_image_contrastive=False,
                        dtype="float32")
  (tmp_path / "benchmark/configs/tiny.json").write_text(json.dumps(tiny))
  cell = {"config": "tiny", "traffic": "train_superbatch", "chips": 1,
          "why": "a test", "limits": {"loss": 1e-3}}
  (tmp_path / "benchmark/workloads/tiny-train.json").write_text(
      json.dumps(cell))
  (tmp_path / "benchmark/metrics/steps_seen.py").write_text(
      "def read(record):\n  return float(record.work)\n")
  bench["configs"].append({"name": "tiny", "source": "a test",
                           "file": "benchmark/configs/tiny.json",
                           "reduced": [], "why": "a test"})
  bench["workloads"].append({"name": "tiny-train", **{
      k: cell[k] for k in ("config", "traffic", "chips", "why")}})
  bench["end_to_end"].append({"name": "steps_seen", "unit": "steps",
                              "better": "higher", "bound": 0.01,
                              "source": "host_clock",
                              "workloads": ["tiny-train"]})
  for m in bench["end_to_end"]:
    if m["name"] == "train_img_per_s":
      m["workloads"].append("tiny-train")
  (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
  script = textwrap.dedent(f"""
      import json, sys, time
      sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]
      import torch
      torch.set_num_threads(2)
      from benchmark import run
      assert run.cells.HERE.parent == __import__("pathlib").Path({str(tmp_path)!r})
      print(json.dumps(run.execute("tiny-train", 7, 0.5, False, "cpu",
                                   time.perf_counter())))
  """)
  out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path)
  assert out.returncode == 0, out.stderr[-3000:]
  result = json.loads(out.stdout.strip().splitlines()[-1])
  assert set(result["metrics"]) == {"train_img_per_s", "setup_s",
                                    "steps_seen"}
  assert result["metrics"]["steps_seen"]["value"] >= 1
  assert result["correct"] and list(result["checks"]) == ["loss"]


def _tower_flops(batch):
  from torch.utils.flop_counter import FlopCounterMode

  tree = layers.Tree()
  nets.resnet50(layers.Scope(tree), torch.zeros(batch, 128, 128, 3,
                                                device="meta"))
  spec = {n: torch.zeros(s, device="meta") for n, (s, _) in tree.spec.items()}
  with FlopCounterMode(display=False) as counter:
    nets.resnet50(layers.Scope(layers.Tree(spec)),
                  torch.zeros(batch, 128, 128, 3, device="meta"))
  return counter.get_total_flops()


@pytest.mark.parametrize("name, per_image", [("coco_xmc", 159.54),
                                             ("coco_xmc_256", 509.49)])
def test_step_flops_per_image(name, per_image):
  """At 2 x 2 the reference's step costs 159.54 GFLOP an image at 128 px
  and 509.49 at 256 px.  The port's step under the same counter adds one
  ResNet-50 forward over the fake images, which it recomputes in the
  backward (4.09 GFLOP a super-batch image): 163.63 and 513.58."""
  cfg = dict(cells.config(name)["config"], batch_size=2, grad_accum_steps=1)
  count = flops.step_flops(cfg) / 4 / 1e9
  assert count == pytest.approx(per_image, abs=0.005)
  with_recompute = count + _tower_flops(2) / 4 / 1e9
  assert with_recompute == pytest.approx(per_image + 4.09, abs=0.01)


def test_cell_step_flops():
  """The counts the MFU of the two cells divides: 18.134 and 263.898
  TFLOP an outer step."""
  small = flops.step_flops(dict(cells.config("coco_xmc")["config"]))
  big = flops.step_flops(dict(cells.config("coco_xmc_256")["config"]))
  assert small / 1e12 == pytest.approx(18.134, abs=0.001)
  assert big / 1e12 == pytest.approx(263.898, abs=0.001)


@pytest.mark.parametrize("n, b_ms, d_ms", [(56, 0.2036, 0.1270),
                                           (128, 0.9631, None)])
def test_word_scores_counts_are_section_6s(n, b_ms, d_ms):
  """PERF.md section 6 bounds B and C by their operations at the 3xTF32
  route's 165 TFLOP/s: 0.2036 ms at 56 and 0.9631 at 128; D 0.1270."""
  ops = word_scores.section6_operations(n, n, 256, 17, 768)
  route = peaks.FLOPS["tf32"] / 3
  assert round(sum(ops.values()) / route * 1e3, 4) == b_ms
  if d_ms is not None:
    assert round(ops["sim"] / route * 1e3, 4) == d_ms
  launch = word_scores.operations_and_bytes(n, n, 256, 17, 768)
  assert launch["drn"][0] == sum(ops.values())
  assert launch["scores"][0] == ops["sim"] + ops["g_alpha"]


@pytest.mark.parametrize("n, fwd_ms, bwd_ms", [(56, 0.0001, 0.0002),
                                               (128, 0.0003, 0.0005)])
def test_ntxent_counts_are_section_6s(n, fwd_ms, bwd_ms):
  """PERF.md section 6 bounds A by its bytes: 0.0001 / 0.0002 ms at 56
  and 0.0003 / 0.0005 at 128 (bf16 features of 1536)."""
  counts = ntxent.operations_and_bytes(n, 1536, 2)
  for op, want in (("fwd", fwd_ms), ("bwd", bwd_ms)):
    ops, nbytes = counts[op]
    bound = max(ops / peaks.FLOPS["bfloat16"],
                nbytes / peaks.HBM_BYTES_PER_S)
    assert bound == nbytes / peaks.HBM_BYTES_PER_S
    assert round(bound * 1e3, 4) == want


def test_cell_shapes_of_the_kernels():
  small = dict(cells.config("coco_xmc")["config"])
  big = dict(cells.config("coco_xmc_256")["config"])
  assert word_scores.shapes(small)["images"] == 56
  assert word_scores.shapes(big)["images"] == 128
  assert word_scores.shapes(big)["regions"] == 256
  assert ntxent.shapes(small) == {"batch": 56, "dim": 1536, "itemsize": 2}
  for cfg in (small, big):
    for family in (word_scores, ntxent):
      assert all(0 < s < 1e-2 for s in family.launch_bounds(cfg).values())


def test_run_seconds_fit_the_check():
  """A full check of 24 cells at this length fits its 43200 s."""
  runs = 2 + 14 * 24
  assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
  assert math.isfinite(BENCH["run_seconds"])

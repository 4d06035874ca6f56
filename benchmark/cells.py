"""The data files of the benchmark, found by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells and metrics;
``workloads/<cell>.json`` holds a cell's configuration, traffic mix,
chips, why and the limits of its comparison; ``configs/<config>.json`` the
configuration as it is run (``config``: every key, set over the port's
``configs/<module>.py``); ``traffic/<mix>.json`` the mix's parameters and
its ``kind``, whose driver is ``traffic/<kind>.py``; ``metrics/<metric>.py``
a metric's reader, ``read(record) -> float | None``.  A later cell,
configuration, mix or metric is a new file of these and an entry in
``BENCHMARK.json``: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from types import ModuleType
from typing import Any, Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(name: str) -> str:
  if not NAME.match(name):
    raise ValueError(f"not a benchmark name: {name!r}")
  return name


def load_json(path: pathlib.Path) -> Dict[str, Any]:
  with open(path) as f:
    return json.load(f)


def benchmark() -> Dict[str, Any]:
  return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> Dict[str, Any]:
  return load_json(HERE / "workloads" / f"{_name(name)}.json")


def config(name: str) -> Dict[str, Any]:
  return load_json(HERE / "configs" / f"{_name(name)}.json")


def mix(name: str) -> Dict[str, Any]:
  return load_json(HERE / "traffic" / f"{_name(name)}.json")


def _module(path: pathlib.Path, label: str) -> ModuleType:
  if not path.is_file():
    raise FileNotFoundError(f"no file {path}")
  spec = importlib.util.spec_from_file_location(label, path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def driver(kind: str) -> ModuleType:
  return _module(HERE / "traffic" / f"{_name(kind)}.py",
                 f"benchmark_traffic_{kind}")


def reader(metric: str) -> ModuleType:
  return _module(HERE / "metrics" / f"{_name(metric)}.py",
                 "benchmark_metric_" + metric.replace(".", "_"))


def metrics_of(bench: Dict[str, Any], cell: str, traced: bool
               ) -> List[Dict[str, Any]]:
  """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
  the per-layer ones traced; a metric with ``workloads`` only in those."""
  entries = bench["per_layer" if traced else "end_to_end"]
  return [m for m in entries if cell in m.get("workloads", [cell])]


def port_config(config_file: Dict[str, Any]):
  """The port's configuration: its ``configs/<module>.py`` with every key
  of the file's ``config`` set over it."""
  from xmcgan_image_generation_tpu_torch.utils.serving import (
      load_config_module,
  )

  cfg = load_config_module(config_file["module"])
  cfg.update(config_file["config"])
  return cfg

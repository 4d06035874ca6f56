"""The evaluation service over two processes on the CPU (gloo) against
one process, on the same global batches.

A test-config checkpoint (float32) trained one step on the CPU is scored
by `evaluate.evaluate_continuously` in two spawned processes
(``eval_batch_size`` 4, 2 rows a process; ``eval_num`` 6, so that the
second batch of each pass keeps process 0's rows only), and by one
process's `EvalMetric` fed the same global batches: process-major
concatenations of ``create_datasets(..., process_index=r,
process_count=2)``'s batches.  (``test_torch_eval_protocol.py`` holds
the two processes' statistics against the JAX package's ``EvalMetric``.)

The InceptionV3 is the seeded one with its BatchNorm statistics fitted to
its input (`_torch_dist.inception_npz`), so that the pool features
spread over 5-20 % of their mean: IS is 1.9-2.3 and FID ~2e6, and a
merge that lost rows would move each by far more than its tolerance.

Tolerances: the merged statistics within 1e-12 relative (with a floor of
1e-12 of the largest value; the float64 sums differ in order only), IS
within 1e-9, FID within 1e-6: the product of two covariances of rank 5 in
2048 dimensions is singular, and ``sqrtm``'s square roots of its 2043
rounding-level eigenvalues move FID when the statistics change in their
last bits (1.7e-9 of itself seen here; up to 3e-8 with a tower whose
features barely varied, between runs with other BLAS thread counts).
``scores.csv`` gets one row, from process 0.

Time: the module takes 70-80 s alone (some 140 s beside other test
workers), over the 60 s aimed at, and a split would not shorten it.  It
waits on six ``sqrtm``s of 2048 x 2048, about 20 s each on two cores,
and each is needed: each of the service's two processes takes two (FID
with the normal and the EMA weights), as every process of the JAX
package's does, and the one-process `EvalMetric` that the row is held
against takes two.  The three processes run at once, so the module's
time is one process's start-up and its two ``sqrtm``s in a row; moving
the one-process reference to a file of its own would leave the service
as long.
"""

import csv
import os

import numpy as np
import pytest
import torch

import _torch_dist as td
from xmcgan_image_generation_tpu_torch import train as train_lib

torch.set_num_threads(1)

ROW_KEYS = ("fid", "fid_std", "inception_score", "inception_score_std",
            "ema_fid", "ema_fid_std", "ema_inception_score",
            "ema_inception_score_std")
WEIGHTS = ("normal", "ema")
BLAS_THREADS = 2   # a spawned process's: three share the cores


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
  """The service at world 2 and one `EvalMetric` on the same global
  batches, in spawned processes at once."""
  tmp = tmp_path_factory.mktemp("service")
  npz = str(tmp / "inception.npz")
  td.inception_npz(npz)
  overrides = dict(inception_ckpt_path=npz)
  config = td.eval_config(num_train_steps=1)
  workdir = str(tmp / "exp")
  train_lib.train(config, workdir, "cpu")
  batches = td.global_eval_batches(config, 4)   # 2 real, 2 generated
  runs = {}
  for name, world, fn, args in (
      ("service", 2, "service_case", (workdir, overrides)),
      ("world1", 1, "eval_metric_case", (workdir, overrides, batches))):
    outdir = str(tmp / name)
    os.makedirs(outdir)
    runs[name] = (td.start(world, fn, outdir, *args,
                           blas_threads=BLAS_THREADS), world, outdir)
  out = {name: td.results(*run) for name, run in runs.items()}
  out["world1"] = out["world1"][0]
  out["workdir"] = workdir
  with open(os.path.join(workdir, "checkpoints", "scores.csv")) as f:
    out["rows"] = list(csv.DictReader(f))
  return out


def _row(scored):
  (row,) = scored["rows"]
  return {k: float(row[f"eval/{k}"]) for k in ROW_KEYS}


def test_one_row_from_process_0(scored):
  """One row for the one checkpoint, appended by process 0 alone; both
  processes scored their 2 x 2 rows of the 6 a weight set (the second
  batch's rows are process 0's)."""
  assert [row["step"] for row in scored["rows"]] == ["1"]
  r0, r1 = scored["service"]
  assert (r0["appended"], r1["appended"]) == (1, 0)
  assert (r0["images"], r1["images"]) == (2 * 4, 2 * 2)
  with open(os.path.join(scored["workdir"], "metrics.jsonl")) as f:
    assert sum('"eval/fid"' in line for line in f) == 1


def test_merges_once_a_pass(scored):
  """The control plane: the start barrier, the step and the end
  broadcast, and one merge for the real statistics and one a weight set
  for the pool and the score (a float64 and an int64 gather each)."""
  for res in scored["service"]:
    counts = res["counts"]
    assert counts["all_gather/host_sum"]["calls"] == 2 * (1 + 2 * 2)
    assert counts["barrier/control"]["calls"] == 1
    assert counts["broadcast/step"]["calls"] == 2


@pytest.mark.parametrize("key", ROW_KEYS)
def test_row_matches_one_process(scored, key):
  want = dict(zip(ROW_KEYS, scored["world1"]["row"]))[key]
  got = _row(scored)[key]
  if key.endswith("_std"):
    assert got == want == 0.0   # one repeat
  elif "fid" in key:
    np.testing.assert_allclose(got, want, rtol=1e-6)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize("weights", WEIGHTS)
def test_statistics_match_one_process(scored, weights):
  want = scored["world1"]
  for res in scored["service"]:
    mu, sigma, score = res["statistics"][weights]
    w_mu, w_sigma, w_score = want["statistics"][weights]
    for got, ref in ((mu, w_mu), (sigma, w_sigma)) + tuple(
        zip(res["real"], want["real"])):
      np.testing.assert_allclose(got, ref, rtol=1e-12,
                                 atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(score, w_score, rtol=1e-9)
  # Both processes hold the same merged bits.
  a, b = (res["statistics"][weights] for res in scored["service"])
  assert all(np.array_equal(x, y) for x, y in zip(a, b))

"""The benchmark of the PyTorch port, ``xmcgan_image_generation_tpu_torch``.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything the harness knows of a cell it reads from data
files found by name: ``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<mix>.json`` (read by the driver ``traffic/<kind>.py``), and
one reader a metric, ``metrics/<metric>.py``.  The yardstick lives here
too: the plain reference (`reference`), the step's operation count
(`flops`), the kernels' operations and bytes (``kernels/``), the card's
peaks (`peaks`), the trace's reduction (`trace`) and the comparison that
decides ``correct`` (`compare`).  Nothing here imports JAX or the JAX
package.
"""

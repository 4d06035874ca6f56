"""XMC-GAN in PyTorch, for one NVIDIA H100.

A port of `xmcgan_image_generation_tpu` (JAX, for a TPU), which stays in
the repository as the reference.  Module paths mirror the JAX package's
(``ops/attention.py`` <-> ``ops/attention.py`` and so on), parameter names
follow its flax scope names (``GenBlock_0``, ``Conv_0``, ...) so that
`utils.bridge` maps weights mechanically, and public functions keep its
NHWC layout.  Every Pallas kernel of the JAX package is a CUDA C++ kernel
for ``sm_90a`` (``csrc/``), bound with ``ctypes`` by ``ops/cuda/``.

This package imports ``torch`` and never ``jax``, nor any module of the
JAX package: it keeps its own copies of the host-side code it needs.
"""

__version__ = "0.1.0"

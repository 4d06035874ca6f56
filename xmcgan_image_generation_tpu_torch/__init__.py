"""XMC-GAN in PyTorch, for one NVIDIA H100.

A port of `xmcgan_image_generation_tpu` (JAX, for a TPU), which stays in
the repository as the reference.  Module paths mirror the JAX package's
(``ops/attention.py`` <-> ``ops/attention.py`` and so on), parameter names
follow its flax scope names (``GenBlock_0``, ``Conv_0``, ...) so that
`utils.bridge` maps weights mechanically, and public functions keep its
NHWC layout.  The two Pallas kernels of the training step are CUDA C++
kernels for ``sm_90a`` (``csrc/``), bound with ``ctypes`` by
``ops/cuda/``.

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

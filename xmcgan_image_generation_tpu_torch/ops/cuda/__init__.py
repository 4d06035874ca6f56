"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

Each module here ports one Pallas file of the JAX package
(``ops/pallas/ntxent.py`` -> `ntxent`, ``ops/pallas/word_scores.py`` ->
`word_scores`).  Beside each kernel's wrapper stands the plain PyTorch
version of the same function.  A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises.
The kernels are compiled from ``csrc/`` at first use (`build`).
"""

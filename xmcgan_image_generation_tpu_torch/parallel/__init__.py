"""Data parallelism over processes (the JAX package's ``parallel/``).

The JAX package runs one SPMD program over a ``(data, model)`` device mesh
and leaves the collectives to XLA.  The port runs one process per device
(`mesh`: the process group, from ``torchrun``'s environment or explicit
arguments), keeps the group where the ops can read it (`context`), and
issues the collectives itself (`collectives`).
"""

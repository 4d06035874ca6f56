"""The frozen plain reference of the benchmark.

XMC-GAN's training step and generator written once more in plain PyTorch,
in float32 (the caller turns TF32 off), as functions of named tensors:
G and D with the five contrastive heads in einsum form, the frozen
ResNet-50 v1 tower, the hinge and NT-Xent losses, Adam and the EMA.  The
names of the tensors are the port's ``state_dict`` keys, so that the
benchmark hands both sides the same seeded tensors by name.

It imports nothing of the port and nothing of JAX: it is the yardstick
that decides whether the port's timed path computed the right thing, and
later changes to the port cannot move it.  `layers` holds the building
blocks, `nets` the three networks, `step` the update rules.
"""

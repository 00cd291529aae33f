"""A frozen copy of the port's plain modules: the benchmark's reference.

The voxelizer, the sparse index plan, the adversary, VFE, the sparse
encoder, the SECOND body, both heads, the targets, losses, decode and NMS
of robustpointclouds_tpu_torch, copied so that the yardstick does not move
with the program: float32 throughout, the sparse conv (K1) a plain gather
and matmul and the masked statistics and batch norm (K2) plain torch, both
differentiated by autograd; the registries, the environment-gated variants
and the compact adversary left out; every product's operands through
`precision.py`, which computes them in float32 or, for the control, one
precision below the configuration's. Nothing here imports the port.
"""

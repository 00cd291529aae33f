"""robustpointclouds_tpu_torch — the PyTorch/CUDA port of robustpointclouds_tpu.

The JAX package beside it stays the reference; every module here keeps its
counterpart's module and function names so a reader can find each pair.
This package imports torch and never jax, nor anything of the JAX package.

Layering (bottom-up):
  kernels/   hand-written Hopper kernels (CUDA C++ sources in csrc/, Triton)
             with their plain PyTorch versions and launch counters
  ops/       box geometry, coder, anchors, NMS, sparse-index helpers
  nn/        torch modules (VFE, SparseEncoder, SECOND, SECONDFPN,
             Anchor3DHead, VoxelPerturber, MaskedBatchNorm)
  models/    AdversarialVoxelNet, anchor-head targets, losses and decoding
  train/     the adversarial train step (two optimizer chains, NaN ladder)
  data/      native sparse-plan builder (ctypes over csrc/plan.cpp),
             synthetic KITTI-like scenes
  tools/     weight bridge from the JAX package's parameter trees, profilers
  cli/       the serving forward and the training entry point
"""

"""Data-parallel training over torch.distributed (counterpart of robustpointclouds_tpu/parallel)."""
from .mesh import average_step, replicate, shard_batch
from .multihost import host_rows, init_multihost, launch_local

__all__ = ["average_step", "replicate", "shard_batch", "host_rows", "init_multihost",
           "launch_local"]

"""Give torch's intra-op thread pool a share of the CPU's cores under pytest-xdist.

Each xdist worker is a process with its own torch pool, sized to every core
by default, so N workers run N pools on one set of cores: their threads spin
against each other and a port test that takes seconds alone takes minutes.
Imported by the port's test files (tests/test_torch_*.py); a run without
xdist keeps torch's default.
"""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))

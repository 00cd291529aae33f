"""parallel/dryrun.dryrun_multichip, the port's counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`: one adversarial train step over N gloo
CPU ranks, each on its row of the global batch with its own host sub-plan.
It raises unless the loss is finite and averaged, step == 1, every rank's
weights, BN buffers and train state are bit-equal after the step, and each
rank saw one row and only its own sub-plan's voxels, which partition the
global plan's; its line follows JAX's format."""
import re

import pytest

from robustpointclouds_tpu_torch.parallel.dryrun import dryrun_multichip
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, capsys):
    out = dryrun_multichip(n)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(rf"dryrun_multichip OK: {n} devices, loss=\d+\.\d{{4}}, "
                        rf"l2=\d+\.\d{{5}}, voxels/device=\d+ \(\d\.\d{{3}}x the global plan's\)",
                        line), line
    assert out["step"] == 1 and out["rows"] == 1
    own = out["own_voxels_by_rank"]
    assert len(own) == n and all(v > 0 for v in own) and sum(own) == out["global_voxels"]
    assert out["l2"] > 0  # the adversary ran (epoch 5)

"""tools/diag_centerpoint_nan on the CPU at CenterPoint's smoke grid.

Each step's line carries the JAX tool's keys; a NaN injected into one
parameter's gradient is named, counted and flagged on the step it appears,
and the step is a NaN step (the parameters keep their values); without it
every gradient is finite and the magnitudes are the largest of the step's
gradients. main() runs on the CPU with --cpu and DIAG_NOADV=1.
"""
import json

import numpy as np
import pytest
import torch

from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
from robustpointclouds_tpu_torch.models.centerpoint import CenterPointConfig
from robustpointclouds_tpu_torch.tools import diag_centerpoint_nan as diag
from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer

import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

# the keys of robustpointclouds_tpu/tools/diag_centerpoint_nan.py's lines
JAX_KEYS = {"step", "loss", "nonfinite_grad_leaves", "n_nonfinite", "is_nan_flag",
            "top_grad_mag"}


def _setup(adversary=True):
    cfg, n = tiny_centerpoint_cfg(CenterPointConfig())
    if not adversary:
        cfg = cfg._replace(adversary=None)
    tr = CenterPointTrainer(cfg, device="cpu")
    tr.init_state(0)
    batch, vel = synthetic_nuscenes_batch(np.random.RandomState(0), batch_size=2, num_points=n,
                                          max_gt=cfg.head.max_objs, num_objects=6,
                                          point_range=cfg.voxelizer.point_cloud_range)
    return tr, batch, vel


def test_lines_carry_the_jax_keys():
    tr, batch, vel = _setup()
    lines = []
    recs = diag.diagnose(tr, batch, vel, 2, emit=lines.append)
    assert [json.loads(x) for x in lines] == recs + [{"done": 2}]
    names = dict(tr.model.named_parameters())
    for i, r in enumerate(recs):
        assert set(r) == JAX_KEYS and r["step"] == i
        assert r["n_nonfinite"] == 0 and r["nonfinite_grad_leaves"] == []
        assert r["is_nan_flag"] is False
        assert len(r["top_grad_mag"]) == 3 and all(k in names for k, _ in r["top_grad_mag"])
        mags = [v for _, v in r["top_grad_mag"]]
        assert mags == sorted(mags, reverse=True) and mags[0] > 0
        assert {"loss", "loss_heatmap", "loss_bbox", "perturbation_l2_norm"} <= set(r["loss"])
    # the largest magnitude is the step's largest gradient entry: the last
    # step's gradients are still on the parameters (sanitised: all finite)
    gmax = max(float(p.grad.abs().max()) for p in tr.model.parameters())
    assert recs[-1]["top_grad_mag"][0][1] == round(gmax, 3)
    assert tr.grad_probe is None and tr.state.step == 2


def test_an_injected_nan_gradient_is_named_and_flagged():
    tr, batch, vel = _setup()
    name = "pts_middle_encoder.conv_out.0.weight"
    param = dict(tr.model.named_parameters())[name]
    handle = param.register_hook(lambda g: g * float("nan"))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    try:
        recs = diag.diagnose(tr, batch, vel, 1, emit=lambda line: None)
    finally:
        handle.remove()
    r = recs[0]
    assert r["nonfinite_grad_leaves"] == [name] and r["n_nonfinite"] == 1
    assert r["is_nan_flag"] is True
    assert np.isfinite(r["loss"]["loss"])  # the loss itself stayed finite
    assert int(tr.state.nan_count) == 1
    for k, v in tr.model.state_dict().items():  # a NaN step changes no weight
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, before[k]), k


def test_main_runs_on_the_cpu(monkeypatch, capsys):
    small, n = tiny_centerpoint_cfg(CenterPointConfig())
    monkeypatch.setattr(diag, "CenterPointConfig", lambda: small)
    real = diag.synthetic_nuscenes_batch
    monkeypatch.setattr(diag, "synthetic_nuscenes_batch", lambda rng, batch_size: real(
        rng, batch_size=batch_size, num_points=n, max_gt=small.head.max_objs, num_objects=6,
        point_range=small.voxelizer.point_cloud_range))
    monkeypatch.setenv("DIAG_STEPS", "1")
    monkeypatch.setenv("DIAG_NOADV", "1")
    recs = diag.main(["--cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "backend: cpu"
    assert json.loads(out[1]) == recs[0] and json.loads(out[-1]) == {"done": 1}
    assert not any(k.startswith("adversary.") for k, _ in recs[0]["top_grad_mag"])
    if not torch.cuda.is_available():  # the card by default: none here, so it raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            diag.main([])

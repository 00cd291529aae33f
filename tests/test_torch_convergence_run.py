"""tools/convergence_run.py, the port's convergence run, on the CPU at the CONV_TINY size.

  * the tiny tier through `main` (2 chunks of 2 steps and a 2-step freeze
    phase into tmp_path): log.jsonl and summary.json carry exactly the keys
    of the JAX run's committed work_dirs/convergence/ files, and
    `final_train_step` is read after the freeze phase, as JAX's is;
  * the chunk epochs follow JAX's ramp: the committed 2000-step log's 40
    epochs, and the tiny run's;
  * the freeze phase leaves the clean detector as phase 1 trained it: the
    clean AP and the eval-mode head outputs bit for bit, the detector's
    parameters unchanged, the adversary's moved;
  * three inline steps across the adversary's epoch-3 gate, from the JAX
    model's weights through the weight bridge, give JAX's
    `Trainer._step_impl` logs step by step, in float32 (PERT_BF16 pinned
    off on both sides) at tests/test_torch_train.py's loss tolerance. The
    port runs on one torch thread there, as tests/torch_dp_ranks.py does:
    oneDNN's reductions follow the thread count, and after two Adam steps
    (which move near-zero gradients' entries by ~lr whatever their sign)
    the losses' distance from JAX's depends on it. Measured, worst over the
    logs relative to each: 1 thread 1.4e-5 / 3.5e-5 / 3.1e-5 a step; 2, 3,
    6 and 8 threads up to 4.4e-5; 4 threads 4.8e-4 at the third step.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.data.structures import PointCloudBatch as JBatch
from robustpointclouds_tpu.tools.convergence_run import _tiny_cfg as jax_tiny_cfg
from robustpointclouds_tpu.train import TrainConfig as JTrainConfig, Trainer as JTrainer

from robustpointclouds_tpu_torch.cli.common import run_evaluation
from robustpointclouds_tpu_torch.tools import convergence_run as conv
from robustpointclouds_tpu_torch.tools.convert import jax_to_state_dict
from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RUN = os.path.join(REPO, "work_dirs", "convergence")
# tests/test_torch_train.py's loss tolerance (float32 both sides)
LOSS_RTOL = 5e-5
LOSS_ATOL = 1e-6
GATE_EPOCHS = (2.0, 3.0, 4.0)  # the adversary's gate opens at epoch 3
TINY_ENV = {"CONV_TINY": "1", "CONV_STEPS": "4", "CONV_SCAN_LEN": "2", "CONV_FREEZE_STEPS": "2",
            "CONV_EPOCHS": "2", "CONV_SCENES": "3", "CONV_EVAL_SCENES": "2"}


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    for k, v in TINY_ENV.items():
        mp.setenv(k, v)
    work = str(tmp_path_factory.mktemp("torch_convergence"))
    out = conv.main(["--cpu", "--work-dir", work])
    mp.undo()
    return work, out


def _jax_keys(name):
    with open(os.path.join(JAX_RUN, name)) as f:
        return set(json.loads(f.readline())) if name.endswith(".jsonl") else set(json.load(f))


def test_tiny_tier_writes_the_jax_runs_keys(tiny_run):
    work, out = tiny_run
    with open(os.path.join(work, "log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(work, "summary.json")) as f:
        summary = json.load(f)
    assert len(recs) == 2 and [r["step"] for r in recs] == [2, 4]
    for r in recs:
        assert set(r) == _jax_keys("log.jsonl")
        assert r["nan_steps"] == 0 and np.isfinite(r["loss"])
    assert [r["train_step"] for r in recs] == [2, 4]
    assert set(summary) == _jax_keys("summary.json")
    assert summary["steps"] == 4 and summary["batch_size"] == 2 and summary["scenes"] == 3
    # JAX's quirk: read from the state after the freeze phase (its 2 steps)
    assert summary["final_train_step"] == 2 and summary["nan_total"] == 0
    assert set(summary["ap_clean_3d_moderate"]) == {
        "Car_3d_moderate", "Pedestrian_3d_moderate", "Cyclist_3d_moderate"}
    with open(os.path.join(work, "device.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [2, 4]


def test_chunk_epochs_follow_jaxs_ramp(tiny_run):
    with open(os.path.join(JAX_RUN, "log.jsonl")) as f:
        jax_epochs = [json.loads(line)["epoch"] for line in f]
    assert len(jax_epochs) == 40
    assert [round(conv.chunk_epoch(ci, 50, 2000, 10.0), 2) for ci in range(40)] == jax_epochs
    assert jax_epochs[12] == 3.0  # the gate opens mid-run
    # the tiny run: 4 steps over 2 epochs -> 2 steps an epoch, chunks of 2
    assert [r["epoch"] for r in tiny_run[1]["records"]] == [0.0, 1.0]


def test_freeze_phase_keeps_the_clean_detector_bit_for_bit():
    cfg = dict(conv.settings(), tiny=True, batch_size=2, num_points=512, scan_len=2,
               freeze_steps=2, num_scenes=2, num_eval=1)
    tr = Trainer(conv.tiny_cfg(), TrainConfig(), device="cpu")
    tr.init_state(0)
    scenes_np = conv.make_scenes(tr.model_cfg, 2, 512, [100, 101])
    eval_np = conv.make_scenes(tr.model_cfg, 2, 512, [900])
    scenes = [conv.to_device(b, tr.device) for b in scenes_np]
    conv.run_chunk(tr, scenes, 3.0, 0, 2)

    def clean(trainer):
        outs = trainer.forward_eval(None, batch=eval_np[0])
        return run_evaluation(trainer, eval_np, attack=False), outs

    ap0, outs0 = clean(tr)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    frz = conv.freeze_phase(tr, scenes, cfg)
    ap1, outs1 = clean(frz)
    assert ap1 == ap0
    for a, b in zip(outs0[:3], outs1[:3]):
        assert torch.equal(a, b)
    after = frz.model.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert moved and all(k.startswith("adversary.") and not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked")) for k in moved), moved
    assert frz.state.step == 2 and frz.train_cfg.freeze_detector


@pytest.fixture(scope="module")
def gate_steps():
    """JAX's and the port's per-step logs over GATE_EPOCHS from the same weights."""
    import robustpointclouds_tpu.nn.perturber as jprt
    import robustpointclouds_tpu_torch.nn.perturber as tprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)
    torch.backends.cudnn.allow_tf32 = False
    threads = torch.get_num_threads()
    try:
        tcfg = conv.tiny_cfg()._replace(compute_dtype="float32")
        scenes_np = conv.make_scenes(tcfg, 2, 512, [100, 101])
        jbatches = [JBatch(*(jnp.asarray(x) for x in b)) for b in scenes_np]
        jtr = JTrainer(model_cfg=jax_tiny_cfg()._replace(compute_dtype="float32"),
                       train_cfg=JTrainConfig())
        state = jtr.init_state(jax.random.PRNGKey(0), jbatches[0])
        sd0 = jax_to_state_dict(state.params, state.batch_stats)
        jstep = jax.jit(jtr._step_impl)
        jlogs = []
        for i, epoch in enumerate(GATE_EPOCHS):
            state, logs = jstep(state, jbatches[i % 2], jnp.float32(epoch))
            jlogs.append({k: float(v) for k, v in logs.items()})

        torch.set_num_threads(1)
        tr = Trainer(tcfg, TrainConfig(), device="cpu")
        tr.init_state(state_dict=sd0)
        scenes = [conv.to_device(b, tr.device) for b in scenes_np]
        tlogs = []
        for i, epoch in enumerate(GATE_EPOCHS):
            logs = conv.run_chunk(tr, scenes, epoch, i, 1)
            tlogs.append({k: float(v[0]) for k, v in logs.items()})
        torch.set_num_threads(threads)
        yield jlogs, tlogs, int(state.step), tr
    finally:
        torch.set_num_threads(threads)
        mp.undo()


@pytest.mark.parametrize("step", range(len(GATE_EPOCHS)))
def test_steps_across_the_gate_match_jax(gate_steps, step):
    jlogs, tlogs, jstep, tr = gate_steps
    j, t = jlogs[step], tlogs[step]
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=f"step {step} epoch {GATE_EPOCHS[step]} {k}")
    assert j["num_pos"] > 0
    # the adversary's terms are on only from the gate's epoch
    assert (t["perturbation_l2_norm"] > 0) == (GATE_EPOCHS[step] >= 3)
    assert jstep == tr.state.step == len(GATE_EPOCHS)

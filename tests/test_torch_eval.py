"""The port's evaluation path against the JAX package, on the CPU in float32.

Both sides get the same weights: the JAX model's initial parameters with
randomised BatchNorm statistics and class-logit biases (so that detections
survive the score threshold), carried over by the port's weight bridge and
saved through each package's own checkpoint manager; the smoke grid of the
CLIs' --tiny (real SECOND widths) in float32 on both sides. Checked:
  * evaluate_checkpoint(..., tiny=True) on tests/fixtures/kitti_mini: the
    same per-frame detections (boxes and scores rtol 1e-4, labels exact)
    and the same AP dict;
  * make_plan_attack at steps=2: the first step's gradient within 1e-4 of
    its scale; the attacked voxels equal on >= 99 % of entries, the rest
    off by at most 2 alpha (a sign(g) flips where |g| is at rounding level);
  * PGD runs the sparse conv's forward and input gradient, never its weight
    gradient, and restores the weights' requires_grad;
  * checkpoints: round trip, max_to_keep, best-metric, warm start;
  * the training CLI writes a checkpoint that the evaluation CLI scores.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustpointclouds_tpu.cli.common as jcommon
from robustpointclouds_tpu.cli.evaluate_kitti_3class import evaluate_checkpoint as j_evaluate
from robustpointclouds_tpu.data.native_plan import build_plan_native
from robustpointclouds_tpu.data.structures import PointCloudBatch as JBatch
from robustpointclouds_tpu.eval.attacks import make_plan_attack as j_make_plan_attack
from robustpointclouds_tpu.models.detection import anchor_head_loss as j_anchor_head_loss
from robustpointclouds_tpu.nn.perturber import _bound_profile
from robustpointclouds_tpu.train import TrainConfig as JTrainConfig, Trainer as JTrainer
from robustpointclouds_tpu.train.checkpoint import CheckpointManager as JCheckpointManager

import robustpointclouds_tpu_torch.cli.common as tcommon
import robustpointclouds_tpu_torch.kernels.sparse_conv as tsc
from robustpointclouds_tpu_torch.cli import evaluate_kitti_3class as t_eval_cli
from robustpointclouds_tpu_torch.cli import train_kitti_3class_adversarial as t_train_cli
from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch as TBatch
from robustpointclouds_tpu_torch.eval.attacks import frozen, make_plan_attack
from robustpointclouds_tpu_torch.tools.convert import jax_to_state_dict
from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager, load_pretrained
from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

from test_model import tiny_batch
from test_torch_serving import _randomise_bn
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

KITTI_MINI = os.path.join(os.path.dirname(__file__), "fixtures", "kitti_mini")
# float32 on both sides, summation order only (the serving parity measures
# ~1e-6 relative through the same forward)
DET_RTOL = 1e-4
GRAD_RTOL = 1e-4
ATTACK_AGREE = 0.99


@pytest.fixture(scope="module")
def setup():
    import robustpointclouds_tpu.nn.perturber as jprt
    import robustpointclouds_tpu_torch.nn.perturber as tprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)
    jcfg = jcommon.tiny_voxelnet_cfg()._replace(compute_dtype="float32")
    tcfg = tcommon.tiny_voxelnet_cfg()._replace(compute_dtype="float32")
    # the CLIs' --tiny config, in float32 on both sides
    mp.setattr(jcommon, "tiny_voxelnet_cfg", lambda: jcfg)
    mp.setattr(tcommon, "tiny_voxelnet_cfg", lambda: tcfg)

    rng = np.random.RandomState(0)
    raw = tiny_batch(rng)
    jtr = JTrainer(model_cfg=jcfg, train_cfg=JTrainConfig())
    state = jtr.init_state(jax.random.PRNGKey(0), JBatch(*(jnp.asarray(x) for x in raw)))
    params = _randomise_bn(dict(state.params), rng)
    stats = _randomise_bn(dict(state.batch_stats), rng)
    cls = params["bbox_head"]["conv_cls"]
    params["bbox_head"]["conv_cls"] = dict(cls, bias=(0.5 * rng.randn(*np.shape(cls["bias"]))
                                                      ).astype(np.float32))
    state = state._replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                           batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    sd = jax_to_state_dict(params, stats)
    yield dict(jcfg=jcfg, tcfg=tcfg, raw=raw, jtr=jtr, state=state, params=params,
               stats=stats, sd=sd)
    mp.undo()


def _port_trainer(s):
    tr = Trainer(s["tcfg"], TrainConfig(), device="cpu")
    tr.init_state(0, state_dict=s["sd"])
    return tr


def test_evaluate_checkpoint_matches_jax_on_kitti_mini(setup, tmp_path):
    s = setup
    JCheckpointManager(str(tmp_path / "jax")).save(0, s["state"])
    CheckpointManager(str(tmp_path / "port")).save(0, _port_trainer(s))
    # batch 2 over the val split's one frame: one padding row, skipped
    ref = j_evaluate(str(tmp_path / "jax"), KITTI_MINI, 2, False, None, tiny=True,
                     dump_results=str(tmp_path / "j.pkl"))
    got = t_eval_cli.evaluate_checkpoint(str(tmp_path / "port"), KITTI_MINI, 2, False, None,
                                         tiny=True, dump_results=str(tmp_path / "t.pkl"),
                                         device="cpu")
    assert got == ref and got["num_frames"] == 1
    assert "Car_aos_moderate" in got  # calib and 2D boxes reached the metric
    with open(tmp_path / "j.pkl", "rb") as f:
        ref_frames = pickle.load(f)
    with open(tmp_path / "t.pkl", "rb") as f:
        got_frames = pickle.load(f)
    assert [f["frame_id"] for f in got_frames] == [f["frame_id"] for f in ref_frames] == ["000002"]
    for r, g in zip(ref_frames, got_frames):
        assert len(g["scores"]) == len(r["scores"]) > 0
        np.testing.assert_array_equal(g["labels"], r["labels"])
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=DET_RTOL, atol=1e-6)
        np.testing.assert_allclose(g["boxes_3d"], r["boxes_3d"], rtol=DET_RTOL, atol=1e-4)


def test_plan_attack_matches_jax(setup):
    s = setup
    jtr, jcfg, raw = s["jtr"], s["jcfg"], s["raw"]
    plan = build_plan_native(raw.points, raw.points_mask, jcfg.voxelizer, 4)  # no assignment
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)
    jb = JBatch(*(jnp.asarray(x) for x in raw))
    ref_attacked = np.asarray(
        j_make_plan_attack(jtr, steps=2)(s["state"].params, s["state"].batch_stats, jb,
                                         plan)["voxels"])

    def det_loss(delta):  # eval/attacks.py's loss at the first step
        m = jplan["point_mask"][..., None].astype(jnp.float32)
        outs = jtr.model.apply({"params": s["state"].params,
                                "batch_stats": s["state"].batch_stats},
                               jb.points, jb.points_mask, False, 100, False, -1.0,
                               dict(jplan, voxels=jplan["voxels"] + delta * m))
        det = j_anchor_head_loss(outs.cls_scores, outs.bbox_preds, outs.dir_preds,
                                 jtr.anchors, jtr.anchor_cls, jb.gt_boxes, jb.gt_labels,
                                 jb.gt_mask, jcfg.head)
        return det["loss_cls"] + det["loss_bbox"] + det["loss_dir"]

    ref_g = np.asarray(jax.jit(jax.grad(det_loss))(jnp.zeros_like(jplan["voxels"])))

    tr = _port_trainer(s)
    attack = make_plan_attack(tr, steps=2)
    gt, plan_t = attack.prepare(TBatch(*raw), plan)
    with frozen(tr.model):
        g = attack.loss_grad(torch.zeros_like(plan_t["voxels"]), gt, plan_t).numpy()
    scale = np.abs(ref_g).max()
    assert scale > 0
    assert np.abs(g - ref_g).max() <= GRAD_RTOL * scale

    got = attack(TBatch(*raw), plan)["voxels"].numpy()
    agree = (got == ref_attacked).mean()
    _, clamp = _bound_profile(4, 0.2, attack=True)
    alpha = 2.5 * clamp / 2
    assert agree >= ATTACK_AGREE, agree
    assert (np.abs(got - ref_attacked) <= 2 * alpha + 1e-5).all()
    pm = plan["point_mask"].astype(bool)
    np.testing.assert_array_equal(got[~pm], plan["voxels"][~pm])  # padding untouched


def test_pgd_runs_no_weight_gradient(setup, monkeypatch):
    s = setup
    calls = {"sparse_conv": 0, "sparse_conv_dgrad": 0, "sparse_conv_wgrad": 0}
    for name in calls:
        fn = getattr(tsc, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(tsc, name, counted)
    tr = _port_trainer(s)
    tr.model.zero_grad(set_to_none=True)
    raw = s["raw"]
    plan = tr.make_plan_builder()(raw.points, raw.points_mask)
    steps = 3
    attacked = make_plan_attack(tr, steps=steps)(TBatch(*raw), plan)
    # 12 sparse convs: a forward and an input gradient each per step, no d_W
    assert calls == {"sparse_conv": 12 * steps, "sparse_conv_dgrad": 12 * steps,
                     "sparse_conv_wgrad": 0}
    assert all(p.requires_grad and p.grad is None for p in tr.model.parameters())
    delta = (attacked["voxels"] - torch.from_numpy(plan["voxels"])).numpy()
    _, clamp = _bound_profile(4, 0.2, attack=True)
    assert (np.abs(delta) <= clamp + 1e-5).all() and np.abs(delta).max() > 0


def test_fgsm_steps_to_the_envelope(setup):
    s = setup
    tr = _port_trainer(s)
    raw = s["raw"]
    plan = tr.make_plan_builder()(raw.points, raw.points_mask)
    delta = (make_plan_attack(tr, steps=1, rel_step=1.0)(TBatch(*raw), plan)["voxels"]
             - torch.from_numpy(plan["voxels"])).numpy()
    _, clamp = _bound_profile(4, 0.2, attack=True)
    pm = plan["point_mask"].astype(bool)
    moved = np.abs(delta[pm]) > 0
    assert moved.mean() > 0.5
    # one signed step of the full clamp: every moved entry sits on the boundary
    np.testing.assert_allclose(np.abs(delta[pm])[moved],
                               np.broadcast_to(clamp, delta[pm].shape)[moved], rtol=1e-6)
    assert np.abs(delta[~pm]).max() == 0.0


def test_checkpoint_round_trip(setup, tmp_path):
    s = setup
    tr = _port_trainer(s)
    st = tr.state
    st.step, st.count = 7, 7
    st.mu = {k: torch.randn_like(v) for k, v in st.mu.items()}
    st.nan_count = torch.tensor(3, dtype=torch.int32)
    mgr = CheckpointManager(str(tmp_path / "wd"), max_to_keep=2)
    assert mgr.latest_epoch() is None
    for epoch in (0, 4, 9):
        mgr.save(epoch, tr)
    assert mgr.epochs() == [4, 9] and mgr.latest_epoch() == 9  # max_to_keep

    other = Trainer(s["tcfg"], TrainConfig(), device="cpu")
    other.init_state(1)
    restored = mgr.restore(other)
    assert restored.step == 7 and restored.count == 7 and int(restored.nan_count) == 3
    for k, v in tr.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    for k in st.mu:
        assert torch.equal(restored.mu[k], st.mu[k]) and torch.equal(restored.nu[k], st.nu[k])

    assert mgr.save_best(10.0, tr, epoch=1) and not mgr.save_best(5.0, tr, epoch=2)
    fresh = Trainer(s["tcfg"], TrainConfig(), device="cpu")
    fresh.init_state(2)
    assert mgr.restore_best(fresh).step == 7
    # warm start: the weights only, from a checkpoint directory
    warm = Trainer(s["tcfg"], TrainConfig(), device="cpu")
    warm.init_state(3)
    load_pretrained(warm, str(tmp_path / "wd"))
    assert warm.state.step == 0
    for k, v in tr.model.state_dict().items():
        assert torch.equal(warm.model.state_dict()[k], v), k
    with pytest.raises(NotImplementedError, match="not ported yet"):
        load_pretrained(warm, "second_zoo.pth")


def test_train_cli_checkpoint_is_scored_by_the_eval_cli(tmp_path, capsys):
    work = str(tmp_path / "wd")
    t_train_cli.main(["--synthetic", "--tiny", "--steps", "2", "--cpu", "--work-dir", work,
                      "--batch-size", "2"])
    assert CheckpointManager(work).epochs() == [0]  # the final save of the one epoch
    res = t_eval_cli.main(["--mode", "clean", "--checkpoint", work, "--tiny", "--cpu",
                           "--data-root", KITTI_MINI, "--batch-size", "2"])
    assert res["clean"]["num_frames"] == 1 and "mAP_3d_moderate" in res["clean"]
    out = capsys.readouterr().out
    assert "restored epoch 0" in out and "clean: SUCCESS" in out


def test_evaluation_refuses_random_init(tmp_path):
    with pytest.raises(FileNotFoundError, match="refusing"):
        t_eval_cli.evaluate_checkpoint(str(tmp_path / "none"), KITTI_MINI, 2, True, 2,
                                       tiny=True, device="cpu")


def test_tta_merge_matches_jax():
    car = [10.0, 5.0, -1.0, 3.9, 1.6, 1.56, 0.3]
    car_dup = [10.02, 5.0, -1.0, 3.9, 1.6, 1.56, 0.3]
    far = [30.0, -5.0, -1.0, 3.9, 1.6, 1.56, 0.0]
    boxes = np.asarray([[car, car_dup, far, car], [far, car, car_dup, far]], np.float32)
    scores = np.asarray([[0.9, 0.8, 0.7, 0.6], [0.5, 0.95, 0.4, 0.45]], np.float32)
    labels = np.asarray([[0, 0, 0, 1], [2, 0, 0, 2]], np.int32)
    valid = np.asarray([[True, True, True, True], [True, True, True, False]])
    ref = jcommon._tta_merge_fn(0.01)(*(jnp.asarray(a) for a in (boxes, scores, labels, valid)))
    got = tcommon._tta_merge_fn(0.01)(*(torch.from_numpy(a) for a in (boxes, scores, labels,
                                                                       valid)))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
    assert got[3].sum().item() == 5  # each sample's duplicate car suppressed

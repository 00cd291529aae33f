"""Zoo warm starts: the port's tools/convert_torch_checkpoint and
train/checkpoint.load_pretrained on a `.pth` against the JAX package's.

No zoo file ships with the repository: each family's mmdet3d state dict is
built from a seed with the shapes of the port model (tests/zoo_checkpoint.py;
SECOND's conv_input in spconv1's layout) and saved as a `.pth`. Per family
(SECOND, PointPillars, CenterPoint with the DCN head and with the plain head
given the DCN file), on the smoke configs in float32:
  * both packages start from the same weights (JAX's init, carried over by
    tools/convert) and warm-start from the same file; the port's state_dict
    is bit-equal, on every key, to tools/convert of JAX's warmed state, and
    the `[load-from]` line counts the same loaded and skipped tensors;
  * one warm-started eval forward on the same host plan agrees with JAX's
    within RTOL = ATOL = 1e-4, the serving tolerance of
    tests/test_torch_serving.py (float32 summation order).
Then each layout decision and each refusal of JAX's converter against the
port's: spconv1, the three 1x1 deblock orientations and their raise, the
ambiguous sparse layout, a dropped trunk tensor, a file that loads nothing,
the pillar-variant CenterPoint, an unknown layout; and the reference's gap:
only each backbone stage's first conv and BN load.
"""
import collections
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.cli.common import tiny_voxelnet_cfg as j_tiny_voxelnet_cfg
from robustpointclouds_tpu.cli.train_nuscenes_adversarial import (
    tiny_centerpoint_cfg as j_tiny_centerpoint_cfg)
from robustpointclouds_tpu.models import centerpoint as jcp
from robustpointclouds_tpu.models import pointpillars as jpp
from robustpointclouds_tpu.models import voxelnet as jvn
from robustpointclouds_tpu.tools import convert_torch_checkpoint as jcvt
from robustpointclouds_tpu.train.checkpoint import load_pretrained as j_load_pretrained

from robustpointclouds_tpu_torch.cli.common import tiny_pointpillars_cfg, tiny_voxelnet_cfg
from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
from robustpointclouds_tpu_torch.models.centerpoint import CenterPointConfig
from robustpointclouds_tpu_torch.models.voxelnet import plan_to_device
from robustpointclouds_tpu_torch.tools import convert_torch_checkpoint as tcvt
from robustpointclouds_tpu_torch.tools.convert import (
    centerpoint_to_state_dict, jax_to_state_dict, pointpillars_to_state_dict,
    sparse_kernel_to_spconv)
from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer
from robustpointclouds_tpu_torch.train.checkpoint import load_pretrained
from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)
from test_pointpillars import tiny_pp_cfg as j_tiny_pp_cfg
from zoo_checkpoint import fake_zoo_state_dict, save_pth

RTOL, ATOL = 1e-4, 1e-4
FAMILIES = ["second", "pointpillars", "centerpoint_dcn", "centerpoint_plain"]
SPCONV1 = "middle_encoder.conv_input.0.weight"
_COUNTS = re.compile(r"\[load-from\] .* \((\w+)\): loaded (\d+) tensors, skipped (\d+)")
JState = collections.namedtuple("JState", "params batch_stats")


def _counts(text):
    m = _COUNTS.search(text)
    assert m, text
    return m.group(1), int(m.group(2)), int(m.group(3))


def _build(name, tmp):
    """JAX's model and initial state, the port trainer on the same weights,
    a seeded host plan and the family's fake zoo `.pth`."""
    pts_rng = np.random.RandomState(3)
    if name == "second":
        jcfg = j_tiny_voxelnet_cfg()._replace(compute_dtype="float32")
        jmodel, bridge = jvn.AdversarialVoxelNet(jcfg), jax_to_state_dict
        trainer = Trainer(tiny_voxelnet_cfg()._replace(compute_dtype="float32"), TrainConfig(),
                          device="cpu")
    elif name == "pointpillars":
        jcfg = j_tiny_pp_cfg()._replace(compute_dtype="float32")
        jmodel, bridge = jpp.AdversarialPointPillars(jcfg), pointpillars_to_state_dict
        trainer = Trainer(tiny_pointpillars_cfg()._replace(compute_dtype="float32"),
                          TrainConfig(), device="cpu")
    else:
        dcn = name == "centerpoint_dcn"
        jcfg, _ = j_tiny_centerpoint_cfg(jcp.CenterPointConfig(compute_dtype="float32",
                                                               use_dcn_head=dcn))
        jmodel, bridge = jcp.AdversarialCenterPoint(cfg=jcfg), centerpoint_to_state_dict
        tcfg, _ = tiny_centerpoint_cfg(CenterPointConfig(compute_dtype="float32",
                                                         use_dcn_head=dcn))
        trainer = CenterPointTrainer(tcfg, device="cpu")
    pcr = trainer.model_cfg.voxelizer.point_cloud_range
    if name.startswith("centerpoint"):
        batch, vel = synthetic_nuscenes_batch(pts_rng, batch_size=2, num_points=512,
                                              max_gt=trainer.model_cfg.head.max_objs,
                                              num_objects=4, point_range=pcr)
        plan = trainer.make_plan_builder()(batch.points, batch.points_mask, batch.gt_boxes,
                                           batch.gt_labels, batch.gt_mask, vel)
    else:
        batch = synthetic_kitti_batch(pts_rng, batch_size=2, num_points=600, max_gt=4,
                                      num_objects=3, point_range=pcr)
        plan = trainer.make_plan_builder()(batch.points, batch.points_mask, batch.gt_boxes,
                                           batch.gt_labels, batch.gt_mask)
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)
    pts, msk = jnp.asarray(batch.points), jnp.asarray(batch.points_mask)
    variables = jax.jit(lambda r, pl: jmodel.init(r, pts, msk, True, 0, plan=pl))(
        jax.random.PRNGKey(0), jplan)
    jstate = JState(dict(variables["params"]), dict(variables["batch_stats"]))
    trainer.init_state(state_dict=bridge(jstate.params, jstate.batch_stats))
    # the CenterPoint files carry the DCN head, whichever head the model has
    src = trainer.model.state_dict()
    if name == "centerpoint_plain":
        src = CenterPointTrainer(tiny_centerpoint_cfg(CenterPointConfig(use_dcn_head=True))[0],
                                 device="cpu").model.state_dict()
    zoo = fake_zoo_state_dict(src, seed=7, spconv1=[SPCONV1] if name == "second" else [])
    path = save_pth(zoo, str(tmp / f"{name}.pth"))
    return dict(jmodel=jmodel, jstate=jstate, bridge=bridge, trainer=trainer, plan=plan,
                jplan=jplan, pts=pts, msk=msk, zoo=zoo, path=path)


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """Each family built once, lazily, and warm-started by both packages."""
    import robustpointclouds_tpu.nn.perturber as jprt
    import robustpointclouds_tpu_torch.nn.perturber as tprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)
    mp.setenv("RPC_CP_REMAT", "0")
    torch.backends.cudnn.allow_tf32 = False
    tmp = tmp_path_factory.mktemp("zoo")
    built = {}

    def get(name, capsys):
        if name not in built:
            f = _build(name, tmp)
            f["before"] = {k: v.clone() for k, v in f["trainer"].model.state_dict().items()}
            capsys.readouterr()
            f["jwarm"] = j_load_pretrained(f["jstate"], f["path"])
            f["jcounts"] = _counts(capsys.readouterr().out)
            load_pretrained(f["trainer"], f["path"])
            f["counts"] = _counts(capsys.readouterr().out)
            built[name] = f
        return built[name]

    yield get
    mp.undo()


@pytest.mark.parametrize("name", FAMILIES)
def test_warm_start_bit_equal_to_jax(families, name, capsys):
    f = families(name, capsys)
    want = f["bridge"](f["jwarm"].params, f["jwarm"].batch_stats)
    got = f["trainer"].model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert f["counts"] == f["jcounts"]
    layout = "second" if name == "second" else name.split("_")[0]
    loaded, skipped = f["counts"][1:]
    assert f["counts"][0] == layout and loaded > 0
    # the plain head skips the DCN adaptations, cls and reg of each of 6 tasks
    assert skipped == (12 if name == "centerpoint_plain" else 0)
    changed = {k for k in got if not torch.equal(got[k], f["before"][k])}
    assert len(changed) == loaded
    assert not any(k.startswith("adversary.") or k.endswith("num_batches_tracked")
                   for k in changed)


def _forward(f):
    st = f["jwarm"]
    ref = jax.jit(lambda v, pl: f["jmodel"].apply(v, f["pts"], f["msk"], False, 100, False,
                                                  -1.0, pl))(
        {"params": st.params, "batch_stats": st.batch_stats}, f["jplan"])
    model = f["trainer"].model.eval()
    with torch.no_grad():
        got = model(None, None, False, 100, False, -1.0, plan_to_device(f["plan"], "cpu"))
    return got, ref


@pytest.mark.parametrize("name", FAMILIES)
def test_warm_started_forward_matches_jax(families, name, capsys):
    got, ref = _forward(families(name, capsys))
    if name.startswith("centerpoint"):
        pairs = [(f"task{t}.{k}", g[k], r[k]) for t, (g, r) in
                 enumerate(zip(got.task_preds, ref.task_preds)) for k in r]
        assert len(pairs) == 6 * 6
    else:
        pairs = [(n, getattr(got, n), getattr(ref, n))
                 for n in ("cls_scores", "bbox_preds", "dir_preds")]
    for what, g, r in pairs:
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape, what
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=ATOL, err_msg=what)


def test_backbone_gap_only_conv0_of_each_stage_loads(families, capsys):
    """The reference's converter stops each backbone stage at mmdet3d's
    parameter-less ReLU: blocks.{s}.0 / .1 load, the later convs keep their
    values. The port copies the gap."""
    f = families("second", capsys)
    sd = f["trainer"].model.state_dict()
    convs = [k for k in sd if k.startswith("backbone.blocks.") and sd[k].dim() == 4]
    first = [k for k in convs if k.split(".")[3] == "0"]
    assert len(first) == 2 and len(convs) == 12
    for k in convs:
        want = f["zoo"][k] if k in first else f["before"][k].numpy()
        np.testing.assert_array_equal(sd[k].numpy(), want, err_msg=k)


def test_spconv1_layout_loads_as_spconv2(families, capsys):
    f = families("second", capsys)
    w1 = f["zoo"][SPCONV1]
    assert w1.shape == (3, 3, 3, 4, 16)
    np.testing.assert_array_equal(f["trainer"].model.state_dict()[SPCONV1].numpy(),
                                  w1.transpose(4, 0, 1, 2, 3))


@pytest.mark.parametrize("layout", ["spconv2", "spconv1"])
def test_sparse_weight_matches_jax_converter(layout):
    w = np.random.RandomState(0).randn(16, 3, 3, 3, 8).astype(np.float32)
    if layout == "spconv1":
        w = np.ascontiguousarray(w.transpose(1, 2, 3, 4, 0))
    got = tcvt.convert_sparse_conv_weight(w)
    np.testing.assert_array_equal(
        got, sparse_kernel_to_spconv(jcvt.convert_sparse_conv_weight(w), (3, 3, 3)))


def test_ambiguous_sparse_layout_raises_as_in_jax():
    w = np.zeros((2, 3, 3, 3, 2), np.float32)
    for cvt in (jcvt, tcvt):
        with pytest.raises(ValueError, match="ambiguous sparse conv weight layout"):
            cvt.convert_sparse_conv_weight(w)


def _bn(sd, prefix, c, rng):
    sd[f"{prefix}.weight"] = rng.rand(c).astype(np.float32) + 0.5
    sd[f"{prefix}.bias"] = rng.randn(c).astype(np.float32)
    sd[f"{prefix}.running_mean"] = rng.randn(c).astype(np.float32)
    sd[f"{prefix}.running_var"] = rng.rand(c).astype(np.float32) + 0.5


def _deblock_sd(w_shape, stage_out=32):
    rng = np.random.RandomState(1)
    sd = {"backbone.blocks.0.0.weight": rng.randn(stage_out, 8, 3, 3).astype(np.float32),
          "neck.deblocks.0.0.weight": rng.randn(*w_shape).astype(np.float32)}
    _bn(sd, "backbone.blocks.0.1", stage_out, rng)
    _bn(sd, "neck.deblocks.0.1", 64, rng)
    return sd


@pytest.mark.parametrize("branch,shape", [("convtranspose", (32, 64, 1, 1)),
                                          ("conv2d", (64, 32, 1, 1)),
                                          ("square", (32, 32, 1, 1)),
                                          ("deconv_k2", (32, 64, 2, 2))])
def test_deblock_orientation_matches_jax(branch, shape):
    """The 1x1 deblock's three branches by the stage out-width (32) and the
    stride-2 ConvTranspose2d: the port's weight equals tools/convert's
    bridge of JAX's kernel (JAX's flip and the bridge's flip back cancel)."""
    sd = _deblock_sd(shape)
    params, _ = jcvt.convert_second_state_dict(sd)
    neck = params["neck"]
    if "deblock0_deconv" in neck:
        want = np.asarray(neck["deblock0_deconv"]["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
    else:
        want = np.asarray(neck["deblock0_conv"]["kernel"]).transpose(2, 3, 0, 1)
    got = tcvt.convert_second_state_dict(sd)["neck.deblocks.0.0.weight"]
    np.testing.assert_array_equal(got, want)
    w = sd["neck.deblocks.0.0.weight"]
    np.testing.assert_array_equal(got, w.transpose(1, 0, 2, 3) if branch == "conv2d" else w)


def test_unorientable_deblock_raises_as_in_jax():
    sd = _deblock_sd((48, 64, 1, 1))
    for cvt in (jcvt, tcvt):
        with pytest.raises(ValueError, match="cannot orient 1x1 neck upsample deblocks.0"):
            cvt.convert_second_state_dict(sd)


@pytest.fixture(scope="module")
def tiny_second():
    tr = Trainer(tiny_voxelnet_cfg(), TrainConfig(), device="cpu")
    tr.init_state(0)
    return tr


def test_dropped_trunk_tensor_raises_as_in_jax(tiny_second, tmp_path):
    """A strict-prefix skip raises in both packages and leaves the model as
    it was."""
    sd = fake_zoo_state_dict(tiny_second.model.state_dict(), seed=1)
    sd["middle_encoder.conv_out.0.weight"] = np.zeros((128, 3, 3, 3, 64), np.float32)
    before = {k: v.clone() for k, v in tiny_second.model.state_dict().items()}
    with pytest.raises(ValueError, match="warm start dropped required tensors"):
        tcvt.merge_into_state_dict(tiny_second.model, tcvt.convert_second_state_dict(sd),
                                   strict_prefixes=("middle_encoder",))
    params, _ = jcvt.convert_second_state_dict(sd)
    model = {"middle_encoder": {"conv_out": {"kernel": np.zeros((3 * 64, 128), np.float32)}}}
    with pytest.raises(ValueError, match="warm start dropped required tensors"):
        jcvt.merge_into_params(model, params, strict_prefixes=("middle_encoder",))
    for k, v in tiny_second.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # a SECOND file for a PointPillars trainer: the sparse encoder has no home
    pp = Trainer(tiny_pointpillars_cfg(), TrainConfig(), device="cpu")
    pp.init_state(0)
    with pytest.raises(ValueError, match=r"dropped required tensors: middle_encoder \(missing"):
        load_pretrained(pp, save_pth(sd, str(tmp_path / "second.pth")))


def test_zero_loaded_raises_as_in_jax(tiny_second, tmp_path):
    path = save_pth({"middle_encoder.unknown_block.0.weight":
                     np.zeros((8, 3, 3, 3, 4), np.float32)}, str(tmp_path / "junk.pth"))
    with pytest.raises(ValueError, match=r"\(detected layout: second\) loaded ZERO parameter"):
        load_pretrained(tiny_second, path)
    with pytest.raises(ValueError, match=r"\(detected layout: second\) loaded ZERO parameter"):
        j_load_pretrained(JState({"middle_encoder": {}}, {}), path)


@pytest.mark.parametrize("case,match", [
    ("pillar_centerpoint", "pillar-variant CenterPoint checkpoints"),
    ("unknown", "unrecognized checkpoint layout")])
def test_layout_refusals_as_in_jax(case, match):
    sd = ({"pts_voxel_encoder.pfn_layers.0.linear.weight": np.zeros((64, 10), np.float32),
           "pts_backbone.blocks.0.0.weight": np.zeros((128, 256, 3, 3), np.float32)}
          if case == "pillar_centerpoint" else
          {"img_backbone.conv1.weight": np.zeros((64, 3, 7, 7), np.float32)})
    for cvt in (jcvt, tcvt):
        with pytest.raises(ValueError, match=match):
            cvt.detect_state_dict_layout(sd)


def test_missing_file_raises_file_not_found(tiny_second, tmp_path):
    with pytest.raises(FileNotFoundError):
        load_pretrained(tiny_second, str(tmp_path / "absent.pth"))


def test_converter_cli_writes_a_port_checkpoint(tmp_path, monkeypatch, capsys):
    """main(): the full-width SECOND Trainer warm-started and saved as
    epoch_0.pt; a warm start from that directory equals one from the .pth.
    The models are built at full width but never run."""
    from robustpointclouds_tpu_torch.models.voxelnet import VoxelNetConfig

    tr = Trainer(VoxelNetConfig(), TrainConfig(), device="cpu")
    tr.init_state(0)
    pth = save_pth(fake_zoo_state_dict(tr.model.state_dict(), seed=5, spconv1=[SPCONV1]),
                   str(tmp_path / "second.pth"))
    loaded, skipped = tcvt.main([pth, "--out", str(tmp_path / "conv"), "--cpu"])
    assert len(loaded) == 86 and skipped == []  # 60 encoder, 10 backbone, 10 neck, 6 head
    assert "loaded 86 tensors; skipped 0" in capsys.readouterr().out
    load_pretrained(tr, pth)
    other = Trainer(VoxelNetConfig(), TrainConfig(), device="cpu")
    other.init_state(1)
    load_pretrained(other, str(tmp_path / "conv"))
    for k, v in tr.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcvt.main([pth, "--out", str(tmp_path / "card")])

"""The port's strong family against the JAX package, on the CPU in float32.

Both sides get the same numpy inputs and the same weights (the JAX
variables through the port's weight bridge), the same SECOND host plan with
the same anchor assignment, and run in float32 (PERT_BF16 pinned off on
both sides, compute_dtype float32), on tests/test_strong.py's tiny setup:
the 16 m smoke grid, adversary (16, 32), and one case at (16, 32, 64, 32)
for the enc/dec indexing of the default depth. Checked against JAX:
strong_dynamic_scale, the StrongVoxelPerturber (eval; train with dropout 0,
with and without the momentum input; ReLU, LeakyReLU, ELU), the plan-fed
StrongAdversarialVoxelNet, two StrongTrainer steps with the anti-adaptation
flag forced each way (p = 0 and 1 make JAX's bernoulli deterministic),
update_dynamic_scaling's scale sequence, the progress monitor, the
registries, and K2's plain versions at C = 256. The random draws torch
cannot replay from JAX's keys (dropout, the anti-adaptation flag) are
checked statistically in the port alone. The strong CLI runs end to end on
synthetic scenes and on tests/fixtures/kitti_mini.

One JAX compile serves every trainer case: the JAX step is jitted once with
the anti-adaptation probability as an argument.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.cli.common import tiny_voxelnet_cfg
from robustpointclouds_tpu.cli.train_kitti_adversarial_strong import (
    AdversarialProgressMonitor as JMonitor)
from robustpointclouds_tpu.core import registry as jregistry
from robustpointclouds_tpu.data.structures import PointCloudBatch
from robustpointclouds_tpu.kernels import masked_stats as jax_masked_stats
from robustpointclouds_tpu.models.strong import StrongVoxelNetConfig as JStrongCfg
from robustpointclouds_tpu.nn import layers as jlayers
from robustpointclouds_tpu.nn.perturber import (StrongVoxelPerturber as JPerturber,
                                                strong_dynamic_scale as j_dynamic_scale)
from robustpointclouds_tpu.train import TrainConfig as JTrainConfig
from robustpointclouds_tpu.train.strong_loop import StrongTrainer as JStrongTrainer

from robustpointclouds_tpu_torch.cli import train_kitti_adversarial_strong as tcli
from robustpointclouds_tpu_torch.core import registry as tregistry
from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch as TBatch
from robustpointclouds_tpu_torch.kernels import masked_stats as tks
from robustpointclouds_tpu_torch.models import strong as tst
from robustpointclouds_tpu_torch.models import voxelnet as tvn
from robustpointclouds_tpu_torch.nn import perturber as tprt
from robustpointclouds_tpu_torch.nn.layers import MaskedBatchNorm as TMaskedBatchNorm
from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig as TVoxelizerConfig
from robustpointclouds_tpu_torch.tools.convert import jax_to_state_dict, perturber_to_state_dict
from robustpointclouds_tpu_torch.train.loop import TrainConfig as TTrainConfig
from robustpointclouds_tpu_torch.train.strong_loop import StrongTrainer as TStrongTrainer

from test_model import tiny_batch
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

KITTI_MINI = os.path.join(os.path.dirname(__file__), "fixtures", "kitti_mini")
TRAIN_KW = dict(warmup_iters=5, max_epochs=2, steps_per_epoch=4)
PERTURBER = {"sensor_error_bound": 0.18, "hidden_channels": (16, 32), "dropout_rate": 0.0}
# float32 on both sides, sums in other orders. Measured: the perturber's
# deltas within 2.2e-6 of their largest entry (train mode's BatchNorms over
# ~200 rows), the model's head outputs within 1e-6, the losses within 1e-6
# relative; the tolerances leave about 10x.
PERT_TOL = 2e-5
HEAD_TOL = 2e-5
LOSS_RTOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def float32_mlp():
    import robustpointclouds_tpu.nn.perturber as jprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)
    yield
    mp.undo()


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


# ---- strong_dynamic_scale and update_dynamic_scaling

@pytest.mark.parametrize("epoch,eff,mag,jitter", [
    (0, None, None, 0.0), (10, None, None, 0.0), (0, 0.05, None, 0.0), (40, 0.05, 0.05, 0.0),
    (3, 0.2, None, 0.03), (3, 0.3, 0.2, -0.1), (7, 0.0999, 0.0999, -0.25), (25, None, 0.05, 0.1),
    (2.5, 0.5, 0.1, 0.0), (100, 0.01, 0.01, 0.3)])
def test_strong_dynamic_scale_matches_jax(epoch, eff, mag, jitter):
    assert tprt.strong_dynamic_scale(epoch, eff, mag, jitter) == j_dynamic_scale(
        epoch, eff, mag, jitter)
    assert tprt.strong_dynamic_scale(epoch, eff, mag, jitter, 3.0) == j_dynamic_scale(
        epoch, eff, mag, jitter, 3.0)


def _scale_logs(n):
    """Logs whose effectiveness |adv| / loss - 1 and magnitude walk across
    both branches' thresholds."""
    rng = np.random.RandomState(5)
    out = []
    for i in range(n):
        loss = float(rng.uniform(0.5, 4.0))
        eff = (0.05, 0.2, 0.6)[(i // 7) % 3]
        out.append({"loss": np.float32(loss), "loss_adversarial": np.float32(-loss * (1 + eff)),
                    "perturbation_l2_norm": np.float32(0.05 if i < 40 else 0.3)})
    return out


def test_update_dynamic_scaling_sequence_matches_jax(setup):
    jtr = JStrongTrainer(setup["jcfg"], JTrainConfig(**TRAIN_KW))
    ttr = TStrongTrainer(setup["tcfg"], TTrainConfig(**TRAIN_KW), device="cpu")
    js, ts = setup["state0"], ttr.init_state(0, batch_size=2)
    got, ref = [], []
    for i, logs in enumerate([None] + _scale_logs(70)):
        epoch = i // 10
        js = jtr.update_dynamic_scaling(js, epoch, logs)
        ts = ttr.update_dynamic_scaling(ts, epoch, logs)
        ref.append(float(js.scale_factor))
        got.append(float(ts.scale_factor))
    assert got == ref  # host numpy on both sides: bit-equal
    assert len(set(ref)) > 20  # the jitter and both history branches moved it


# ---- the perturber

def _perturber_inputs(seed=0, n=300):
    rng = np.random.RandomState(seed)
    feats = (rng.randn(n, 4) * np.array([10.0, 8.0, 1.0, 0.3]) + [20, 0, -1, 0.4])
    mask = rng.rand(n) < 0.7
    last = rng.randn(n, 4) * 0.05
    return feats.astype(np.float32), mask, last.astype(np.float32)


@pytest.mark.parametrize("hidden", [(16, 32), (16, 32, 64, 32)])
@pytest.mark.parametrize("activation", ["ReLU", "LeakyReLU", "ELU"])
@pytest.mark.parametrize("mode", ["eval", "train", "train_momentum"])
def test_perturber_matches_jax(hidden, activation, mode):
    feats, mask, last = _perturber_inputs(seed=len(hidden))
    kw = dict(num_features=4, sensor_error_bound=0.18, hidden_channels=hidden,
              dropout_rate=0.0, activation=activation)
    jp = JPerturber(**kw)
    fj, mj = jnp.asarray(feats), jnp.asarray(mask)
    v = jp.init(jax.random.PRNGKey(len(hidden)), fj, mj, True)
    tp = tprt.StrongVoxelPerturber(**kw)
    tp.load_state_dict(perturber_to_state_dict(v["params"], v["batch_stats"]))
    train = mode != "eval"
    last_j = jnp.asarray(last) if mode == "train_momentum" else None
    last_t = torch.from_numpy(last) if mode == "train_momentum" else None
    scale = 1.3
    if train:
        (jpert, jaux), mut = jp.apply(v, fj, mj, True, scale, last_j, mutable=["batch_stats"])
        tp.train()
    else:
        jpert, jaux = jp.apply(v, fj, mj, False, scale, last_j)
        tp.eval()
    with torch.no_grad():
        tpert, taux = tp(torch.from_numpy(feats), torch.from_numpy(mask), scale, last_t)
    assert _rel(tpert.numpy(), jpert) <= PERT_TOL
    assert np.all(tpert.numpy()[~mask] == 0.0)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    if train:  # the BatchNorms' running statistics moved the same way
        sd = tp.state_dict()
        for name, st in mut["batch_stats"].items():
            np.testing.assert_allclose(sd[f"{name}.running_mean"].numpy(), st["mean"],
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(sd[f"{name}.running_var"].numpy(), st["var"],
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_dropout_keep_rate_and_scaling():
    """The three dropout rates of the default adversary (0.1, x1.5, x0.5):
    the kept share within 5 binomial sigmas of 1 - rate, kept units scaled
    by exactly 1 / (1 - rate) in the input's type, the rest 0."""
    n = 200000
    gen = torch.Generator().manual_seed(0)
    for rate in (0.1, 0.1 * 1.5, 0.1 * 0.5):
        for dtype in (torch.float32, torch.bfloat16):
            h = torch.ones(n, dtype=dtype)
            out = tprt._dropout(h, rate, gen)
            kept = out != 0
            sigma = (n * rate * (1 - rate)) ** 0.5
            assert abs(int(kept.sum()) - n * (1 - rate)) <= 5 * sigma
            assert torch.equal(out[kept], (h / (1.0 - rate))[kept])


def test_dropout_draws_come_from_the_given_generator():
    feats, mask, _ = _perturber_inputs(seed=3)
    p = tprt.StrongVoxelPerturber(hidden_channels=(16, 32), dropout_rate=0.1).train()
    f, m = torch.from_numpy(feats), torch.from_numpy(mask)
    with torch.no_grad():
        with pytest.raises(ValueError):  # no generator: never the global one
            p(f, m, deterministic=False)
        a = p(f, m, deterministic=False, generator=torch.Generator().manual_seed(7))[0]
        b = p(f, m, deterministic=False, generator=torch.Generator().manual_seed(7))[0]
        c = p(f, m, deterministic=False, generator=torch.Generator().manual_seed(8))[0]
        d = p(f, m)[0]  # deterministic: no dropout
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def test_anti_adaptation_rate_and_replay():
    """The anti-adaptation flag at p = 0.1 over 20000 draws, within 5
    binomial sigmas; the same seed replays the same draws."""
    cfg = tst.StrongVoxelNetConfig(base=_port_base(), perturber=PERTURBER,
                                   anti_adaptation_prob=0.1)
    trs = [TStrongTrainer(cfg, TTrainConfig(**TRAIN_KW), device="cpu") for _ in range(3)]
    for tr, seed in zip(trs, (3, 3, 4)):
        tr.init_state(seed)
    n = 20000
    draws = [torch.stack([tr._anti_draw() for _ in range(n)]) for tr in trs]
    sigma = (n * 0.1 * 0.9) ** 0.5
    assert abs(int(draws[0].sum()) - 0.1 * n) <= 5 * sigma
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])


# ---- the model and the trainer against JAX

def _port_base():
    jb = tiny_voxelnet_cfg()
    vz = jb.voxelizer
    return tvn.VoxelNetConfig(
        voxelizer=TVoxelizerConfig(vz.point_cloud_range, vz.voxel_size, vz.max_points_per_voxel,
                                   vz.max_voxels),
        anchor_ranges=jb.anchor_ranges, adversary=None, compute_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    jcfg = JStrongCfg(base=tiny_voxelnet_cfg()._replace(adversary=None, compute_dtype="float32"),
                      perturber=PERTURBER, anti_adaptation_prob=0.0)
    tcfg = tst.StrongVoxelNetConfig(base=_port_base(), perturber=PERTURBER,
                                    anti_adaptation_prob=0.0)
    jtr = JStrongTrainer(jcfg, JTrainConfig(**TRAIN_KW))
    raw = tiny_batch(np.random.RandomState(0))
    batch = PointCloudBatch(*(jnp.asarray(x) for x in raw))
    plan = jax.tree_util.tree_map(np.asarray, jtr.make_plan_builder()(
        np.asarray(raw.points), np.asarray(raw.points_mask), np.asarray(raw.gt_boxes),
        np.asarray(raw.gt_labels), np.asarray(raw.gt_mask)))
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)
    state0 = jtr.init_state(jax.random.PRNGKey(0), batch)

    def step(state, p):
        # the anti-adaptation probability as a traced argument: one compile
        # serves p = 0 and p = 1
        jtr.model_cfg = jcfg._replace(anti_adaptation_prob=p)
        try:
            return jtr._step_impl(state, batch, jplan)
        finally:
            jtr.model_cfg = jcfg

    sd0 = jax_to_state_dict(state0.params, state0.batch_stats)
    return dict(jcfg=jcfg, tcfg=tcfg, jtr=jtr, raw=TBatch(*raw), batch=batch, plan=plan,
                jplan=jplan, state0=state0, jstep=jax.jit(step), sd0=sd0)


def _port_model(s):
    model = tst.StrongAdversarialVoxelNet(s["tcfg"])
    model.load_state_dict(s["sd0"])
    return model


@pytest.mark.parametrize("mode", ["eval", "train", "train_clean"])
def test_model_matches_jax_plan_fed_apply(setup, mode):
    s = setup
    st = s["state0"]
    rng = np.random.RandomState(1)
    mom = rng.randn(*st.momentum.shape).astype(np.float32) * 0.02
    v = {"params": st.params, "batch_stats": st.batch_stats}
    train, apply_pert = mode != "eval", mode != "train_clean"
    # jitted: one compile a mode takes less than the eager forward's per-op ones
    apply = jax.jit(lambda v, mom, plan: s["jtr"].model.apply(
        v, s["batch"].points, s["batch"].points_mask, train, 1.7, mom,
        -0.5 if train else 0.0, apply_pert, plan=plan, mutable=["batch_stats"])[0])
    jout = apply(v, jnp.asarray(mom), s["jplan"])
    model = _port_model(s)
    with torch.no_grad():
        tout = model(None, None, train, 1.7, torch.from_numpy(mom), -0.5 if train else 0.0,
                     apply_pert, tvn.plan_to_device(s["plan"], torch.device("cpu")))
    for name in ("cls_scores", "bbox_preds", "dir_preds"):
        a, b = getattr(tout, name).numpy(), np.asarray(getattr(jout, name))
        assert a.shape == b.shape and _rel(a, b) <= HEAD_TOL, name
    if apply_pert:
        assert _rel(tout.perturbations.numpy(), jout.perturbations) <= PERT_TOL
        assert float(np.abs(np.asarray(jout.perturbations)).max()) > 0
    else:
        assert float(tout.perturbations.abs().max()) == 0.0
    for k in jout.adv_aux:
        np.testing.assert_allclose(float(tout.adv_aux[k]), float(jout.adv_aux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def _adam_moments(opt_state, batch_stats):
    """(mu, nu) of a JAX optax chain's Adam state, by the port's parameter names."""
    import optax

    adam = [x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)]
    assert len(adam) == 1
    return (jax_to_state_dict(adam[0].mu, batch_stats),
            jax_to_state_dict(adam[0].nu, batch_stats))


def _load_jax_state(tr, js):
    """The port trainer's model and state set to JAX's StrongTrainState `js`:
    parameters, BN statistics, each chain's Adam moments on its own
    parameters, the update count, the momentum carry and the scale."""
    tr.model.load_state_dict(jax_to_state_dict(js.params, js.batch_stats))
    (dmu, dnu), (amu, anu) = (_adam_moments(o, js.batch_stats)
                              for o in (js.opt_state_det, js.opt_state_adv))
    st = tr.state
    for k in st.mu:
        adv = tr.is_adversary(k)
        st.mu[k] = (amu if adv else dmu)[k].clone()
        st.nu[k] = (anu if adv else dnu)[k].clone()
    st.step = st.count = int(js.step)
    st.momentum = torch.from_numpy(np.asarray(js.momentum)).clone()
    st.scale_factor = torch.tensor(float(js.scale_factor))


@pytest.mark.parametrize("anti", [0.0, 1.0])
def test_two_trainer_steps_match_jax(setup, anti):
    """Each of two steps from the same state on both sides (the second from
    JAX's state after the first): the logs, the parameters and BN
    statistics after it, and the momentum it leaves for the next step."""
    s = setup
    jstates = [s["state0"]]
    jlogs = []
    for _ in range(2):
        js, logs = s["jstep"](jstates[-1], jnp.float32(anti))
        jstates.append(js)
        jlogs.append(logs)
    cfg = s["tcfg"]._replace(anti_adaptation_prob=anti)
    tr = TStrongTrainer(cfg, TTrainConfig(**TRAIN_KW), device="cpu")
    tr.init_state(state_dict=s["sd0"], batch_size=2)
    lr = TTrainConfig(**TRAIN_KW).learning_rate
    for i in range(2):
        if i:  # the second step starts where JAX's first ended
            _load_jax_state(tr, jstates[1])
            assert float(tr.state.momentum.abs().max()) > 0  # a carried momentum
        tlogs = tr.train_step(s["raw"], 0, s["plan"])
        assert sorted(tlogs) == sorted(jlogs[i])
        for k in jlogs[i]:
            np.testing.assert_allclose(float(tlogs[k]), float(jlogs[i][k]), rtol=LOSS_RTOL,
                                       atol=1e-6, err_msg=f"step {i} {k}")
        assert float(tlogs["anti_adaptation"]) == anti
        js = jstates[i + 1]
        ref = jax_to_state_dict(js.params, js.batch_stats)
        got = tr.model.state_dict()
        # Adam moves each parameter by about lr * sign(g) a step, whatever
        # |g|: where g is float32 noise on both sides the updates can differ
        # by 2 lr (tests/test_torch_train.py); the bulk is held closer
        diffs = []
        for k, t in got.items():
            if k.endswith("num_batches_tracked"):
                continue
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(t.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5,
                                           err_msg=k)
                continue
            d = np.abs(t.numpy() - ref[k].numpy())
            assert d.max() <= 2 * lr, (k, d.max())
            diffs.append(d.ravel())
        assert np.quantile(np.concatenate(diffs), 0.99) <= 0.05 * lr
        # the momentum the next step carries: this step's perturbations
        assert _rel(tr.state.momentum.numpy(), js.momentum) <= PERT_TOL
        assert float(tr.state.momentum.abs().max()) > 0
        assert tr.state.step == int(js.step) == i + 1
    for k in ("middle_encoder.conv_input.0.weight", "adversary.enc_0.weight"):
        assert not torch.equal(tr.model.state_dict()[k], s["sd0"][k])
    tr.reset_momentum(tr.state)
    assert float(tr.state.momentum.abs().max()) == 0.0


# ---- the progress monitor, the CLI and the registries

def _histories():
    sustained = [{"loss_adversarial": -5.0, "loss_cls": 1.0, "perturbation_l2_norm": 0.1,
                  "attack_scale": 1.0}] * 20
    weakened = [{"loss_adversarial": -10.0}] * 10 + [{"loss_adversarial": -1.0}] * 10
    uneven = [{"loss_adversarial": -float(v)} for v in np.linspace(8.0, 6.5, 13)]
    return {"sustained": sustained, "weakened": weakened, "uneven": uneven, "short": uneven[:3]}


@pytest.mark.parametrize("kind", ["sustained", "weakened", "uneven", "short"])
def test_progress_monitor_matches_jax(kind, tmp_path):
    jm, tm = JMonitor(), tcli.AdversarialProgressMonitor()
    for i, logs in enumerate(_histories()[kind]):
        jm.record(i // 10, i % 10, logs)
        tm.record(i // 10, i % 10, logs)
    assert tm.strength_retention() == jm.strength_retention()
    assert tm.verdict() == jm.verdict()
    assert ("SUCCESSFUL" in tm.verdict()) == (kind != "weakened")
    tm.save(str(tmp_path))
    assert (tmp_path / "adversarial_progress.csv").read_text().count("\n") == len(tm.history) + 1
    assert (tmp_path / "adversarial_progress.json").exists()


def test_strong_cli_on_synthetic_scenes(tmp_path):
    out = tcli.main(["--tiny", "--steps", "2", "--cpu", "--synthetic",
                     "--work-dir", str(tmp_path)])
    for name in ("epoch_0.pt", "adversarial_progress.csv", "adversarial_progress.json"):
        assert (tmp_path / name).exists(), name
    tr = out["trainer"]
    assert tr.state.step == 2 and len(out["monitor"].history) == 1
    assert float(tr.state.momentum.abs().max()) > 0


def test_strong_cli_validates_on_kitti_mini(tmp_path):
    out = tcli.main(["--tiny", "--cpu", "--data-root", KITTI_MINI, "--validate", "--epochs", "2",
                     "--steps-per-epoch", "1", "--work-dir", str(tmp_path)])
    for name in ("epoch_1.pt", "best.pt", "val_history.json", "adversarial_progress.json"):
        assert (tmp_path / name).exists(), name
    assert "val_epoch1" in out["history"]
    assert out["history"]["val_epoch1"]["num_frames"] == 1  # kitti_mini's one val frame
    # the checkpoint carries the strong state: it restores into a new trainer
    from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager

    tr = out["trainer"]
    fresh = TStrongTrainer(tr.model_cfg, tr.train_cfg, device="cpu")
    st = CheckpointManager(str(tmp_path)).restore(fresh)
    assert st.step == tr.state.step == 2
    assert torch.equal(st.scale_factor, tr.state.scale_factor)


def test_registries_build_every_family_by_name():
    tiny = tvn.VoxelNetConfig(voxelizer=_port_base().voxelizer)
    assert isinstance(tregistry.build_adversary({"type": "VoxelPerturber"}), tprt.VoxelPerturber)
    strong = tregistry.build_adversary({"type": "StrongVoxelPerturber",
                                        "hidden_channels": (16, 32)})
    assert isinstance(strong, tprt.StrongVoxelPerturber) and strong.depth == 2
    assert isinstance(tregistry.build_model({"type": "VoxelNet", "cfg": tiny}),
                      tvn.AdversarialVoxelNet)
    for name in ("CenterPoint", "PointPillars", "StrongAdversarialVoxelNet"):
        assert type(tregistry.build_model({"type": name})).__name__.endswith(name)
    assert tregistry.build_model(None) is None
    with pytest.raises(KeyError):
        tregistry.build_model({"type": "NoSuchDetector"})
    # the port registers every name the JAX package does
    import robustpointclouds_tpu.models.centerpoint  # noqa: F401  (registers CenterPoint)
    import robustpointclouds_tpu.models.pointpillars  # noqa: F401

    assert set(tregistry.MODELS.keys()) == set(jregistry.MODELS.keys())
    assert set(tregistry.ADVERSARIES.keys()) == set(jregistry.ADVERSARIES.keys())


# ---- K2 at C = 256: the plain versions against JAX

@pytest.mark.parametrize("n", [600, 1])
def test_k2_plain_versions_at_256_match_jax(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(n, 256) * 3 + 1).astype(np.float32)
    mask = rng.rand(n) < 0.7
    mask[0] = True
    gm, gv = rng.randn(256).astype(np.float32), rng.randn(256).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    mean, var, cnt = tks.masked_stats(xt, torch.from_numpy(mask))
    ((mean * torch.from_numpy(gm)).sum() + (var * torch.from_numpy(gv)).sum()).backward()
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    jmean, jvar, jcnt = jax_masked_stats(xj, mj)  # the Pallas kernel, interpreted
    np.testing.assert_allclose(mean.detach().numpy(), jmean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var.detach().numpy(), jvar, rtol=1e-4, atol=1e-4)
    assert float(cnt) == float(jcnt)
    jdx = jax.grad(lambda a: jnp.sum(jax_masked_stats(a, mj)[0] * gm)
                   + jnp.sum(jax_masked_stats(a, mj)[1] * gv))(xj)
    np.testing.assert_allclose(xt.grad.numpy(), jdx, rtol=1e-4, atol=1e-6)


def test_k2_fused_batch_norm_plain_version_at_256_matches_flax():
    rng = np.random.RandomState(9)
    n = 700
    x = (rng.randn(n, 256) * 2 - 1).astype(np.float32)
    mask = rng.rand(n) < 0.6
    g = rng.randn(n, 256).astype(np.float32)
    jbn = jlayers.MaskedBatchNorm()
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), True)
    v = {"params": {"scale": jnp.asarray(rng.rand(256) + 0.5, jnp.float32),
                    "bias": jnp.asarray(rng.randn(256) * 0.1, jnp.float32)},
         "batch_stats": v["batch_stats"]}

    def jloss(params, a):
        y, mut = jbn.apply({"params": params, "batch_stats": v["batch_stats"]}, a,
                           jnp.asarray(mask), True, mutable=["batch_stats"])
        y = jnp.where(jnp.asarray(mask)[:, None], jax.nn.relu(y), 0.0)
        return jnp.sum(y * g), (y, mut)

    (_, (jy, jmut)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    bn = TMaskedBatchNorm(256)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.asarray(v["params"]["scale"])))
        bn.bias.copy_(torch.from_numpy(np.asarray(v["params"]["bias"])))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt, torch.from_numpy(mask), relu=True, row_mask=True)
    (y * torch.from_numpy(g)).sum().backward()
    assert _rel(y.detach().numpy(), jy) <= 1e-5
    assert _rel(xt.grad.numpy(), jgx) <= 1e-4
    assert _rel(bn.weight.grad.numpy(), jgp["scale"]) <= 1e-4
    assert _rel(bn.bias.grad.numpy(), jgp["bias"]) <= 1e-4
    np.testing.assert_allclose(bn.running_mean.numpy(), jmut["batch_stats"]["mean"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), jmut["batch_stats"]["var"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n,dtype", [(16000, torch.bfloat16), (96000, torch.bfloat16),
                                     (16000, torch.float32), (96000, torch.float32)])
def test_row_plan_at_the_strong_adversarys_256_wide_batch_norms(n, dtype):
    """enc_bn_2 and dec_bn_1 at B * 16000 rows: a row is one warp of 8
    channels a thread (two 16-byte loads a thread for float32), one wave."""
    for reduce in (True, False):
        p = tks.row_plan(n, 256, dtype, reduce)
        assert (p.vec, p.lanes, p.rows_per_block) == (8, 32, 8)
        assert p.blocks == min(-(-n // (8 * (tks._REDUCE_ROWS if reduce else 1))),
                               tks._SMS * tks._BLOCKS_PER_SM)
        assert p.workspace_floats == (p.blocks * 513 if reduce else 0)

"""The greedy NMS keep-mask, the operator rpc::greedy_keep (kernels/greedy_nms.py), on the CPU.

  * its CPU route (the plain loop) through ops/nms._greedy_keep, which
    flattens the leading dimensions, against an independent per-row
    transcription of the sweep, on random symmetric and asymmetric
    relations, some rows all invalid;
  * the card kernel's algorithm (csrc/greedy_nms.cu: the relation packed
    into 64-bit words, then a walk from kept box to kept box), replayed in
    Python, against the same transcription;
  * a box that is not kept suppresses nothing;
  * rotated_nms, circle_nms and topk_nms_3d reach the operator;
  * the fake under torch.export: a tiny SECOND and a tiny CenterPoint
    export with one rpc::greedy_keep node a sweep, and the loaded artifact
    equals the eager serve.
The kernel itself against the plain version: tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch

from robustpointclouds_tpu_torch.cli import export as texport
from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg
from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
from robustpointclouds_tpu_torch.kernels import greedy_nms
from robustpointclouds_tpu_torch.models import centerpoint as tcp
from robustpointclouds_tpu_torch.models import voxelnet as tvn
from robustpointclouds_tpu_torch.ops import nms
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

SIZES = [1, 2, 63, 64, 65, 100, 500]
LEADS = [(), (3,), (4, 6)]


def _loop(over: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The sweep row by row: keep i when valid and no earlier kept j has over[j, i]."""
    n = valid.shape[-1]
    o, v = over.reshape(-1, n, n), valid.reshape(-1, n)
    keep = np.zeros_like(v)
    for r in range(v.shape[0]):
        for i in range(n):
            keep[r, i] = v[r, i] and not np.any(keep[r, :i] & o[r, :i, i])
    return keep.reshape(valid.shape)


def _relation(rng, lead, n, symmetric, p=0.08):
    over = rng.random_sample((*lead, n, n)) < p
    if symmetric:
        over = over | np.swapaxes(over, -1, -2)
        idx = np.arange(n)
        over[..., idx, idx] = True
    valid = rng.random_sample((*lead, n)) < 0.8
    flat = valid.reshape(-1, n)
    flat[1::3] = False  # every third row all invalid, where there are rows to spare
    return over, flat.reshape(valid.shape)


def _walk(over: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """csrc/greedy_nms.cu's algorithm on [R, N, N] / [R, N]: each box's
    row of the relation and the valid mask as 64-bit words (bit i of word w
    is box 64w + i), then one walk a row from the lowest candidate of each
    word to the next, ORing a kept box's later words into `removed`."""
    rows, n = valid.shape
    words = -(-n // 64)

    def pack(bits):  # [..., n] bool -> [..., words] Python ints
        b = np.packbits(bits, axis=-1, bitorder="little")
        b = np.concatenate([b, np.zeros((*b.shape[:-1], words * 8 - b.shape[-1]), np.uint8)], -1)
        return b.view("<u8").astype(object)

    keep = np.zeros((rows, n), bool)
    for r in range(rows):
        rel, cand_bits = pack(over[r]), pack(valid[r])
        removed = [0] * words
        for w in range(words):
            cand = int(cand_bits[w]) & ~removed[w]
            while cand:
                b = (cand & -cand).bit_length() - 1
                j = 64 * w + b
                keep[r, j] = True
                cand &= ~(int(rel[j, w]) | (1 << b))
                for u in range(w + 1, words):
                    removed[u] |= int(rel[j, u])
    return keep


@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "asymmetric"])
@pytest.mark.parametrize("lead", LEADS, ids=lambda s: "x".join(map(str, s)) or "none")
@pytest.mark.parametrize("n", SIZES)
def test_cpu_route_matches_the_loop(n, lead, symmetric):
    rng = np.random.RandomState(n * 7 + len(lead))
    over, valid = _relation(rng, lead, n, symmetric)
    before = greedy_nms.KERNEL_LAUNCHES["plain"]
    keep = nms._greedy_keep(torch.from_numpy(over), torch.from_numpy(valid))
    assert greedy_nms.KERNEL_LAUNCHES["plain"] == before + 1  # one call for every row
    assert keep.dtype == torch.bool and tuple(keep.shape) == valid.shape
    np.testing.assert_array_equal(keep.numpy(), _loop(over, valid))


@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "asymmetric"])
@pytest.mark.parametrize("n", SIZES + [130, 700])
def test_kernel_walk_matches_the_loop(n, symmetric):
    rng = np.random.RandomState(1000 + n)
    over, valid = _relation(rng, (5,), n, symmetric, p=0.02 if n > 200 else 0.08)
    np.testing.assert_array_equal(_walk(over, valid), _loop(over, valid))


@pytest.mark.parametrize("case", ["invalid", "suppressed", "chain"])
def test_a_box_not_kept_suppresses_nothing(case):
    n = 5
    over = torch.zeros(n, n, dtype=torch.bool)
    valid = torch.ones(n, dtype=torch.bool)
    if case == "invalid":  # box 1 is invalid; its relation to 2 and 3 counts for nothing
        valid[1] = False
        over[1, 2] = over[1, 3] = True
        want = [True, False, True, True, True]
    elif case == "suppressed":  # 0 suppresses 1; 1 would suppress 2, but is not kept
        over[0, 1] = over[1, 2] = True
        want = [True, False, True, True, True]
    else:  # a chain: 0 -> 1 -> 2 -> 3 -> 4 keeps every other box
        for j in range(n - 1):
            over[j, j + 1] = True
        want = [True, False, True, False, True]
    assert nms._greedy_keep(over, valid).tolist() == want
    # the relation is read as "row j suppresses column i": transposed, the
    # later boxes suppress earlier ones, which the sweep never asks
    assert nms._greedy_keep(over.T.contiguous(), valid).tolist() == valid.tolist()


@pytest.mark.parametrize("bad", ["over_dtype", "valid_dtype", "not_square", "rows"])
def test_operator_rejects_what_it_cannot_take(bad):
    over = torch.zeros(2, 4, 4, dtype=torch.bool)
    valid = torch.ones(2, 4, dtype=torch.bool)
    if bad == "over_dtype":
        over = over.float()
    elif bad == "valid_dtype":
        valid = valid.int()
    elif bad == "not_square":
        over = torch.zeros(2, 4, 3, dtype=torch.bool)
    else:
        valid = torch.ones(3, 4, dtype=torch.bool)
    with pytest.raises((TypeError, ValueError)):
        greedy_nms.greedy_keep(over, valid)
    with pytest.raises(ValueError):  # a meta tensor would get the fake's empty mask
        greedy_nms.greedy_keep(torch.zeros(1, 4, 4, dtype=torch.bool, device="meta"),
                               torch.zeros(1, 4, dtype=torch.bool, device="meta"))


def test_opcheck():
    rng = np.random.RandomState(3)
    over, valid = _relation(rng, (4,), 70, False)
    torch.library.opcheck(greedy_nms.greedy_keep_op,
                          (torch.from_numpy(over), torch.from_numpy(valid)))


def _boxes(rng, lead, n):
    xy = rng.uniform(-6, 6, (*lead, n, 2))
    rest = np.concatenate([rng.uniform(-1, 1, (*lead, n, 1)), rng.uniform(1, 3, (*lead, n, 3)),
                           rng.uniform(-3, 3, (*lead, n, 1))], -1)
    return torch.from_numpy(np.concatenate([xy, rest], -1).astype(np.float32))


@pytest.mark.parametrize("which", ["rotated", "circle", "circle_per_row", "topk_rotated",
                                   "topk_circle"])
def test_nms_reaches_the_operator(which):
    rng = np.random.RandomState(5)
    boxes = _boxes(rng, (2, 3), 40)
    valid = torch.from_numpy(rng.random_sample((2, 3, 40)) < 0.9)
    seen = []
    orig = greedy_nms.greedy_keep_ref

    def spy(over, v):
        seen.append((over.clone(), v.clone()))
        return orig(over, v)

    before = greedy_nms.KERNEL_LAUNCHES["plain"]
    mp = pytest.MonkeyPatch()
    mp.setattr(greedy_nms, "greedy_keep_ref", spy)
    try:
        if which == "rotated":
            keep = nms.rotated_nms(boxes[..., [0, 1, 3, 4, 6]], None, valid, 0.1)
        elif which == "circle":
            keep = nms.circle_nms(boxes[..., :2], valid, 1.5)
        elif which == "circle_per_row":
            keep = nms.circle_nms(boxes[..., :2], valid,
                                  torch.tensor([[1.0, 4.0, 9.0], [0.5, 2.0, 3.0]]))
        else:
            scores = torch.from_numpy(rng.random_sample((2, 3, 40)).astype(np.float32))
            labels = torch.zeros(2, 3, 40, dtype=torch.int32)
            keep = nms.topk_nms_3d(boxes, scores, labels, valid, nms_pre=30, max_num=20,
                                   use_rotate_nms=which == "topk_rotated", circle_radius=1.5)[3]
    finally:
        mp.undo()
    assert greedy_nms.KERNEL_LAUNCHES["plain"] == before + 1
    assert len(seen) == 1
    over, v = seen[0]
    assert over.shape == (6, v.shape[-1], v.shape[-1])  # (2, 3) leading rows flattened
    if not which.startswith("topk"):
        want = _loop(over.numpy(), v.numpy()).reshape(keep.shape)
        np.testing.assert_array_equal(keep.numpy(), want)
        assert 0 < int(keep.sum()) < int(valid.sum())  # some boxes suppressed, some kept


def _second():
    cfg = tiny_voxelnet_cfg()._replace(compute_dtype="float32")
    model = tvn.AdversarialVoxelNet(cfg)
    tvn.init_weights(model, torch.Generator().manual_seed(0))
    b = synthetic_kitti_batch(np.random.RandomState(1), batch_size=2, num_points=600, max_gt=4,
                              num_objects=3, point_range=cfg.voxelizer.point_cloud_range)
    anchors, _ = cfg.make_anchors()
    return (model, anchors, cfg.head._replace(score_thr=0.0), 600,
            (np.asarray(b.points), np.asarray(b.points_mask)))


def _centerpoint():
    cfg, npts = tiny_centerpoint_cfg(tcp.CenterPointConfig(compute_dtype="float32"))
    model = tcp.AdversarialCenterPoint(cfg)
    tvn.init_weights(model, torch.Generator().manual_seed(0))
    frames = synthetic_nuscenes_batch(np.random.RandomState(2), batch_size=2, num_points=npts,
                                      max_gt=cfg.head.max_objs,
                                      point_range=cfg.voxelizer.point_cloud_range)[0]
    return (model, None, cfg.head._replace(score_thr=0.0), npts,
            (np.asarray(frames.points), np.asarray(frames.points_mask)))


@pytest.mark.parametrize("family", ["second", "centerpoint"])
def test_export_records_the_operator(family, tmp_path):
    model, anchors, head, npts, (pts, msk) = {"second": _second,
                                              "centerpoint": _centerpoint}[family]()
    serve = texport.export_serving(model, None, anchors, head, device="cpu")
    before = greedy_nms.KERNEL_LAUNCHES["plain"]
    want = serve(pts, msk)
    sweeps = greedy_nms.KERNEL_LAUNCHES["plain"] - before
    assert sweeps == 1  # SECOND: every (sample, class); CenterPoint: the six tasks of one k
    ep, meta = texport.export_program(model, anchors, head, 2, npts, device="cpu")
    assert greedy_nms.KERNEL_LAUNCHES["plain"] == before + sweeps  # tracing runs the fake
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert sum(t == "rpc.greedy_keep.default" for t in targets) == sweeps
    path = str(tmp_path / f"{family}.pt2")
    texport.save_exported(ep, meta, path)
    call, _ = texport.load_exported(path)
    got = call(torch.from_numpy(pts), torch.from_numpy(msk))
    assert greedy_nms.KERNEL_LAUNCHES["plain"] == before + 2 * sweeps
    assert int(want[3].sum()) > 0  # detections survive the decode
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)

"""Shared CLI machinery: the training and evaluation drivers and metric logging (counterpart of robustpointclouds_tpu/cli/common.py).

Training is one explicit loop: data -> host plan in the prefetch thread ->
train step -> NaN ladder at log boundaries -> periodic checkpoint and
validation (best-metric checkpoint), with the perturbation-metrics CSV dump
matching the reference's `save_l2_norms` schema (voxel_perturber.py:411-432)
and TensorBoard scalar events under `work_dir/tf_logs`. It warm-starts from
a port checkpoint (`load_from`), resumes from the newest one (`resume`) and
traces steps 10-13 with torch.profiler (`profile_dir`). Evaluation: host
plan -> (attack) -> eval forward -> decode + NMS -> the KITTI AP metric
(CenterPoint's NuScenes evaluation: cli/train_nuscenes_adversarial).
Data parallel (`run_training(group=...)`): every rank runs the same seeded
loader, keeps its rows and builds only its own plan; rank 0 alone reads a
warm start or a resume and then broadcasts the state, writes checkpoints,
CSVs and TensorBoard, and validates.
"""
from __future__ import annotations

import contextlib
import csv
import dataclasses
import hashlib
import json
import os
import pickle
import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.tensorboard import TensorBoardWriter
from ..data.synthetic import PointCloudBatch, synthetic_kitti_batch
from ..eval.attacks import make_plan_attack
from ..eval.kitti_metric import KittiMetric
from ..models.detection import anchor_head_predict
from ..ops import boxes as box_ops
from ..ops.nms import _suppression_sweep
from ..parallel import mesh as dp
from ..train.checkpoint import CheckpointManager, load_pretrained
from ..train.hooks import NaNLadder, reinit_adversary_params
from ..train.loop import HostPlanBuilder, Trainer


def parse_ported_args(parser, argv: Optional[List[str]], prog: str):
    """parser.parse_args, where a flag the parser does not declare raises "not
    ported yet"."""
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        raise SystemExit(f"{prog}: {' '.join(unknown)}: not ported yet")
    return args


AMP_HELP = ("bfloat16 matmul precision for the float32 dense work (the reference's --amp; "
            "K1's float32 sparse convs stay 3xTF32)")


@contextlib.contextmanager
def amp_precision(enabled: bool):
    """The training CLIs' --amp, JAX's `jax_default_matmul_precision =
    bfloat16`: while the block runs, float32 matmuls may compute in bfloat16
    (`torch.set_float32_matmul_precision("medium")`) and cuDNN's float32
    convolutions in TF32 (`torch.backends.cudnn.allow_tf32`), so the float32
    dense work -- a float32 config's backbone, neck and heads, CenterPoint's
    float32 CenterHead -- takes the tensor cores. Both settings are put back
    on exit, so an in-process caller sees no change. The bf16 default configs
    compute in bf16 already; K1's float32 route (csrc/sparse_conv_tf32.cu)
    stays 3xTF32 whatever this says."""
    if not enabled:
        yield
        return
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("medium")
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def add_data_parallel_args(parser, multihost: bool = True) -> None:
    """The JAX CLIs' data-parallel flags: --devices N, and (cli/train) the
    --multihost family."""
    parser.add_argument("--devices", type=int, default=None,
                        help="data-parallel ranks on this machine: one a card (cuda:0..N-1), "
                             "or N CPU processes with --cpu")
    if not multihost:
        return
    parser.add_argument("--multihost", action="store_true",
                        help="one rank of a multi-process job, one card a process (LOCAL_RANK "
                             "picks it): the reference's --launcher pytorch")
    parser.add_argument("--coordinator", default=None,
                        help="rank 0's host:port (or JAX_COORDINATOR_ADDRESS, or torchrun's "
                             "MASTER_ADDR / MASTER_PORT)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="process count (or JAX_NUM_PROCESSES / WORLD_SIZE)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's rank (or JAX_PROCESS_ID / RANK)")


def check_devices(devices: int, batch_size: int, cpu: bool, batch_flag: str) -> None:
    """The JAX CLIs' refusals of --devices N: more cards than attached (on
    the card), a batch that N does not divide."""
    if not cpu and torch.cuda.device_count() < devices:
        raise SystemExit(f"--devices {devices} but only {torch.cuda.device_count()} attached")
    if batch_size % devices:
        raise SystemExit(f"{batch_flag} {batch_size} not divisible by --devices {devices}")


def launch_devices(fn: Callable, devices: int, argv: List[str], cpu: bool,
                   work_dir: str) -> List:
    """--devices N: fn(rank, N, argv) in N spawned ranks on this machine
    (gloo over CPU processes with --cpu, else NCCL with rank r on cuda:r),
    met through a file in `work_dir`; returns their results in rank order."""
    from ..parallel.multihost import launch_local

    os.makedirs(work_dir, exist_ok=True)
    print(f"[devices] data-parallel over {devices} {'CPU processes' if cpu else 'cards'}",
          flush=True)
    return launch_local(fn, devices, (argv,), backend="gloo" if cpu else "nccl",
                        init_file=os.path.join(os.path.abspath(work_dir),
                                               f".rendezvous_{os.getpid()}"),
                        use_cuda=not cpu)


def picklable_result(out: Dict) -> Dict:
    """run_training's result without the train state (device tensors), as a
    spawned rank returns it."""
    return {k: v for k, v in out.items() if k != "state"}


class MetricsLogger:
    """Accumulates per-step scalars; writes the reference-compatible CSVs and
    TensorBoard scalar events `train/<key>` (step = the logged row's index)
    into `work_dir/tf_logs`, the reference's TensorBoard backend."""

    def __init__(self, work_dir: str):
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.l2_norms: List[float] = []
        self.l2_percentages: List[float] = []
        self.rows: List[Dict[str, float]] = []
        self._tb = TensorBoardWriter(os.path.join(work_dir, "tf_logs"))

    def log_step(self, logs: Dict) -> None:
        row = {k: float(v) for k, v in logs.items() if np.ndim(v) == 0}
        step = len(self.rows)
        self.rows.append(row)
        if "perturbation_l2_norm" in row:
            self.l2_norms.append(row["perturbation_l2_norm"])
            self.l2_percentages.append(row.get("l2_percentage", 0.0))
        for k, v in row.items():
            self._tb.add_scalar(f"train/{k}", v, step)
        self._tb.flush()

    def close(self) -> None:
        self._tb.close()

    def save_l2_norms(self, filename: str = "l2_norms.csv") -> str:
        path = os.path.join(self.work_dir, filename)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["L2 Norm", "L2 Percentage", "Constraint Violations"])
            for n, pct in zip(self.l2_norms, self.l2_percentages):
                w.writerow([n, pct, 0.0])
        detailed = [r for r in self.rows if "perturbation_l2_norm" in r]
        if detailed:
            fields = ["l2_norm", "l2_percentage", "max_perturbation",
                      "mean_perturbation", "std_perturbation", "constraint_violation"]
            with open(path.replace(".csv", "_detailed.csv"), "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields)
                w.writeheader()
                for r in detailed:
                    w.writerow({"l2_norm": r.get("perturbation_l2_norm", 0.0),
                                "l2_percentage": r.get("l2_percentage", 0.0),
                                "max_perturbation": r.get("max_perturbation", 0.0),
                                "mean_perturbation": r.get("mean_perturbation", 0.0),
                                "std_perturbation": r.get("std_perturbation", 0.0),
                                "constraint_violation": 0.0})
        return path

    def save_history(self, filename: str = "train_log.jsonl") -> str:
        path = os.path.join(self.work_dir, filename)
        with open(path, "w") as f:
            for r in self.rows:
                f.write(json.dumps(r) + "\n")
        return path


def synthetic_loader(batch_size: int, steps_per_epoch: int, num_points: int = 20000,
                     seed: int = 0, point_range=(0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
                     ) -> Callable[[int], Iterator[PointCloudBatch]]:
    """Epoch -> iterator of synthetic numpy batches, seeded per epoch."""
    def epoch_iter(epoch: int):
        rng = np.random.RandomState(seed * 10007 + epoch)
        for _ in range(steps_per_epoch):
            yield synthetic_kitti_batch(rng, batch_size=batch_size, num_points=num_points,
                                        point_range=point_range)

    return epoch_iter


def prefetch_iterator(it: Iterator, depth: int = 2) -> Iterator:
    """Run `it` in a background thread behind a bounded queue, so the host
    work of producing the next item (the plan build) overlaps the step. A
    producer failure is re-raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(sentinel)
        except BaseException as e:  # noqa: BLE001 - transported to the consumer, re-raised there
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=60)


def with_plans(plan_builder: HostPlanBuilder, it: Iterator) -> Iterator:
    """(batch, host plan) per item of `it`: the input pipeline that
    run_training puts behind prefetch_iterator. An item is a PointCloudBatch
    or a tuple (batch, *extra GT arrays) whose extras go to the builder after
    the batch's GTs (NuScenes: the velocities). Each build's time is in
    `plan_builder.timings`."""
    for item in it:
        # a bare PointCloudBatch is itself a NamedTuple: test it first
        batch, extra = (item, ()) if isinstance(item, PointCloudBatch) else (item[0], item[1:])
        yield batch, plan_builder(batch.points, batch.points_mask, batch.gt_boxes,
                                  batch.gt_labels, batch.gt_mask, *extra)


def tiny_voxelnet_cfg():
    """Shrunken-grid smoke config of the CLIs' --tiny flags: real SECOND
    channel widths on a 16 m grid."""
    from ..models.voxelnet import VoxelNetConfig
    from ..ops.voxelize import VoxelizerConfig

    return VoxelNetConfig(
        voxelizer=VoxelizerConfig(point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
                                  voxel_size=(0.5, 0.5, 0.125), max_points_per_voxel=3,
                                  max_voxels=512),
        anchor_ranges=tuple((0, -8.0, -0.6, 16.0, 8.0, -0.6) for _ in range(3)),
    )


def tiny_pointpillars_cfg():
    """The pillar family's smoke config: its real widths on a 16 m grid of
    0.5 m pillars, 128 pillars of 8 points, adversary (8, 16, 8)
    (tests/test_pointpillars.py's tiny setup)."""
    from ..models.pointpillars import PointPillarsConfig
    from ..ops.voxelize import VoxelizerConfig

    return PointPillarsConfig(
        voxelizer=VoxelizerConfig(point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
                                  voxel_size=(0.5, 0.5, 4.0), max_points_per_voxel=8,
                                  max_voxels=128),
        anchor_ranges=((0, -8.0, -1.78, 16.0, 8.0, -1.78), (0, -8.0, -0.6, 16.0, 8.0, -0.6),
                       (0, -8.0, -0.6, 16.0, 8.0, -0.6)),
        adversary={"sensor_error_bound": 0.2, "use_spatial_attention": True,
                   "hidden_channels": (8, 16, 8)},
    )


def run_training(trainer: Trainer, epoch_loader: Callable[[int], Iterator[PointCloudBatch]],
                 work_dir: str, max_epochs: int, log_interval: int = 50, seed: int = 0,
                 checkpoint_interval: int = 5, max_keep: int = 10, val_interval: int = 5,
                 val_loader: Optional[Callable[[], Iterator]] = None, resume: bool = False,
                 load_from: Optional[str] = None, profile_dir: Optional[str] = None,
                 evaluate: Optional[Callable[[Trainer, Iterator], Dict[str, float]]] = None,
                 group=None) -> Dict:
    """The training loop (the reference scenario:
    train_kitti_3class_adversarial.py --validate), on one device or, with
    `group`, data parallel.

    The host plan (native index plan + anchor assignment) is built in the
    prefetch thread, overlapping the device step; `plan_build_ms` in the
    logs is the newest build's time, which must stay below the step time for
    the input pipeline to be free. A checkpoint (train/checkpoint.py) is
    written into `work_dir` every `checkpoint_interval` epochs and after the
    last, the newest `max_keep` kept.

    `load_from`: warm start of the model weights from a port checkpoint (a
    file or a directory) or a zoo `.pth` (train/checkpoint.load_pretrained).
    `resume`: restore the
    newest checkpoint of `work_dir` and go on at the next epoch.
    `val_loader`: () -> batches for `evaluate` (run_evaluation, the KITTI
    metric, by default) every `val_interval` epochs; the best
    `mAP_3d_moderate` (else `mAP`) is kept as best.pt. The trainer may be
    a CenterPointTrainer, its epoch loader yielding (batch, velocities).
    `profile_dir`: a torch.profiler Chrome trace of steps 10-13 of the first
    epoch (closed early if the epoch ends first). The result holds the
    newest plan builds' timings ("plans", HostPlanBuilder.timings) and each
    epoch's seconds and frames/s ("epochs").

    `group`: a torch.distributed process group, one rank a device (the
    reference's DDP, JAX's mesh). Every rank runs `epoch_loader` with the
    same seed over the global batch, keeps its rows (parallel/mesh.
    shard_batch) and builds only its own plan; the trainer's step is its
    data-parallel one (compile_sharded). Rank 0 alone loads `load_from` and
    `resume`, then broadcasts the model and train state; it alone writes
    checkpoints, the CSVs and TensorBoard, validates and profiles. Frames/s
    counts the global batch. The ranks' final states are compared by
    digest (a mismatch raises) and every rank waits at a barrier before
    returning."""
    rank, world = dp.rank_and_world(group)
    primary = rank == 0
    if group is not None:
        trainer.compile_sharded(group)
    os.makedirs(work_dir, exist_ok=True)
    logger = MetricsLogger(work_dir) if primary else None
    ladder = NaNLadder()
    plan_builder = trainer.make_plan_builder()
    ckpt = CheckpointManager(work_dir, max_to_keep=max_keep,
                             save_interval_epochs=checkpoint_interval, group=group)
    on_card = trainer.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(trainer.device)

    def local_rows(it: Iterator) -> Iterator:
        for item in it:
            yield dp.shard_batch(item, rank, world)

    if trainer.state is None:
        trainer.init_state(seed)
    if load_from and primary:
        load_pretrained(trainer, load_from)
    start_epoch = 0
    if resume and primary:
        latest = ckpt.latest_epoch()
        if latest is not None:
            ckpt.restore(trainer)
            start_epoch = latest + 1
            print(f"[resume] restored epoch {latest} from {work_dir}", flush=True)
        else:
            print(f"[resume] no checkpoint in {work_dir}, starting fresh", flush=True)
    if group is not None:
        trainer.replicate(group)
        start_epoch, = dp.broadcast_ints([start_epoch], group)
        print(f"[dp] rank {rank}/{world} on {trainer.device}, {dist.get_backend(group)}",
              flush=True)
    reinit_gen = torch.Generator().manual_seed(seed)
    history: Dict = {}
    epochs: List[Dict] = []
    prof = None
    t_start = time.time()
    epoch = start_epoch
    for epoch in range(start_epoch, max_epochs):
        epoch_t0 = time.time()
        n_frames = 0
        items = epoch_loader(epoch)
        if group is not None:
            items = local_rows(items)
        batches = prefetch_iterator(with_plans(plan_builder, items))
        for i, (batch, plan) in enumerate(batches):
            if primary and profile_dir and epoch == start_epoch and i == 10:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU] + (
                    [torch.profiler.ProfilerActivity.CUDA] if on_card else []))
                prof.__enter__()
            logs = trainer.train_step(batch, epoch=epoch, plan=plan)
            if prof is not None and i == 13:
                _close_profile(prof, profile_dir, sync)
                prof = None
            n_frames += batch.points.shape[0] * world
            if (i + 1) % log_interval == 0 or i == 0:
                logs = {k: float(v) for k, v in logs.items()}
                logs["plan_build_ms"] = round(plan_builder.timings[-1]["plan_ms"], 1)
                if trainer.model.adversary is not None:
                    ladder.update(trainer.state, adversary_reinit_fn=lambda: reinit_adversary_params(
                        trainer.model.adversary, reinit_gen))
                if primary:
                    logger.log_step(logs)
                    print(f"[epoch {epoch} iter {i + 1}] "
                          + " ".join(f"{k}={v:.4f}" for k, v in sorted(logs.items())), flush=True)
                if ladder.should_stop:
                    print("[NaN ladder] too many consecutive NaNs - stopping", flush=True)
                    break
        if prof is not None:  # the epoch ended inside the profiled window
            _close_profile(prof, profile_dir, sync)
            prof = None
        dt = time.time() - epoch_t0
        if primary:
            print(f"[epoch {epoch}] done in {dt:.1f}s ({n_frames / max(dt, 1e-9):.2f} frames/s)",
                  flush=True)
        epochs.append({"epoch": epoch, "s": dt, "frames": n_frames,
                       "frames_per_s": n_frames / max(dt, 1e-9)})
        ckpt.maybe_save(epoch, trainer)
        if primary and val_loader is not None and (epoch + 1) % val_interval == 0:
            metrics = (evaluate or run_evaluation)(trainer, val_loader())
            history[f"val_epoch{epoch}"] = metrics
            print(f"[val epoch {epoch}] {metrics}", flush=True)
            # keep the best-mAP checkpoint (the reference CheckpointHook's save_best)
            key = "mAP_3d_moderate" if "mAP_3d_moderate" in metrics else "mAP"
            if key in metrics and ckpt.save_best(metrics[key], trainer, epoch):
                print(f"[ckpt] new best {key}={metrics[key]:.2f} (epoch {epoch})", flush=True)
        if ladder.should_stop:
            break
    ckpt.save(max_epochs - 1, trainer)
    if primary:
        logger.save_l2_norms()
        logger.save_history()
        logger.close()
    history["wall_time_s"] = time.time() - t_start
    history["final_epoch"] = epoch
    out = {"state": trainer.state, "history": history, "work_dir": work_dir,
           "start_epoch": start_epoch, "plans": list(plan_builder.timings), "epochs": epochs}
    if group is not None:
        out["state_sha256"] = _equal_replicas(trainer, group)
        dp.barrier(group, trainer.device)
    return out


def state_digest(trainer: Trainer) -> str:
    """sha256 over the model's state_dict and the train state's tensors and
    counters, in a fixed order: equal digests, equal replicas."""
    h = hashlib.sha256()
    st = trainer.state
    items = list(trainer.model.state_dict().items())
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        items += sorted(v.items()) if isinstance(v, dict) else [(f.name, v)]
    for k, v in items:
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes() if isinstance(v, torch.Tensor)
                 else repr(v).encode())
    return h.hexdigest()


def _equal_replicas(trainer: Trainer, group) -> str:
    """Every rank's state digest, gathered: raises unless all are equal."""
    rank, world = dp.rank_and_world(group)
    mine = state_digest(trainer)
    every = [None] * world
    dist.all_gather_object(every, mine, group=group)
    if len(set(every)) != 1:
        raise RuntimeError(f"data-parallel replicas diverged: state digests {every}")
    print(f"[dp] rank {rank}/{world}: {world} replicas equal, state sha256 {mine}", flush=True)
    return mine


def _close_profile(prof, profile_dir: str, sync: Callable[[], None]) -> None:
    """Stop the profiler and write its Chrome trace into `profile_dir`."""
    sync()
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[profile] wrote trace to {path}", flush=True)


# the JAX driver reads `head.nms_iou_threshold`, which AnchorHeadConfig does
# not have, so its flip-TTA merge always runs at its 0.01 default
_TTA_NMS_THR = 0.01


def _tta_merge_fn(nms_thr: float) -> Callable:
    """Merge original + unflipped-flip detections [B, K, ...]: score-sort
    each sample, then class-aware rotated-BEV NMS (mmdet3d
    merge_aug_bboxes_3d semantics)."""
    def merge(boxes, scores, labels, valid):
        order = torch.argsort(-torch.where(valid, scores, torch.full_like(scores, -float("inf"))),
                              dim=-1, stable=True)
        b = torch.gather(boxes, 1, order[..., None].expand(*order.shape, boxes.shape[-1]))
        s, lab, v = (torch.gather(t, 1, order) for t in (scores, labels, valid))
        bev = box_ops.boxes3d_to_bev(b)
        iou = box_ops.rotated_bev_iou(bev, bev)
        same = lab[..., :, None] == lab[..., None, :]
        keep = _suppression_sweep(torch.where(same, iou, torch.zeros_like(iou)), v, nms_thr)
        return b, s, lab, v & keep

    return merge


def _flip_y(batch: PointCloudBatch) -> PointCloudBatch:
    """The batch mirrored in y: points, and the GT boxes with their yaw (a
    gradient attack's loss needs the GTs in the flipped frame)."""
    pts = np.array(batch.points, np.float32)
    pts[..., 1] *= -1.0
    gt = np.array(batch.gt_boxes, np.float32)
    gt[..., 1] *= -1.0
    gt[..., 6] *= -1.0
    return batch._replace(points=pts, gt_boxes=gt)


def run_evaluation(trainer: Trainer, batches, attack: bool = False,
                   dump_path: Optional[str] = None, tta: bool = False,
                   attack_method: str = "learned", attack_steps: int = 10,
                   timings: Optional[Dict] = None) -> Dict[str, float]:
    """Clean or attack-mode evaluation of the trainer's model -> KITTI AP dict.

    attack=True with attack_method "learned" forces the learned adversary
    with the evaluation-attack bounds (the reference's
    evaluate_kitti_adversarial_attack); "pgd" / "fgsm" attack the plan's
    voxels with white-box gradients under the same physical envelope
    (eval/attacks.py). dump_path: per-frame detections (frame_id, boxes_3d,
    scores, labels) as a pickle. tta=True adds the y-flip test-time
    augmentation: a second forward on the mirrored cloud, its detections
    unflipped and merged by class-aware rotated NMS.

    `batches` yields PointCloudBatches or (batch, metas) pairs from
    data/kitti.kitti_val_loader; rows whose meta is not `valid` (padding of
    the last short batch) are not scored. `timings`, when given, is filled
    with "batches" (per batch: host-clock ms of the host plan, of the device
    work up to the detections on the host, and of the metric updates) and
    "ap_ms" (the final AP computation).
    """
    # a StrongTrainer wraps the base detector config under .base
    cfg = getattr(trainer.model_cfg, "base", trainer.model_cfg)
    # 2d/aos compute only when the loader supplies image-plane metas
    metric = KittiMetric(classes=tuple(cfg.class_names), metrics=("3d", "bev", "2d", "aos"))
    plan_builder = trainer.make_plan_builder()
    attack_fn = None
    if attack and attack_method != "learned":
        if hasattr(trainer.model_cfg, "base"):
            raise ValueError(f"attack_method={attack_method!r} needs an anchor-head Trainer "
                             "(the strong family attacks with its learned adversary only)")
        if attack_method == "fgsm":
            attack_fn = make_plan_attack(trainer, steps=1, rel_step=1.0)
        elif attack_method == "pgd":
            attack_fn = make_plan_attack(trainer, steps=attack_steps)
        else:
            raise ValueError(f"unknown attack_method {attack_method!r}")
    merge = _tta_merge_fn(_TTA_NMS_THR) if tta else None
    batch_times: List[Dict[str, float]] = []

    def detect(batch):
        """(detections on the device, host-plan seconds) of one batch."""
        t0 = time.perf_counter()
        plan = plan_builder(batch.points, batch.points_mask)  # no GTs: no assignment
        t_plan = time.perf_counter() - t0
        if attack_fn is not None:
            # the gradient attack rewrites the plan's voxels; the forward then
            # runs clean (the perturbation is already in the input)
            outs = trainer.forward_eval(attack_fn(batch, plan), attack=False)
        else:
            outs = trainer.forward_eval(plan, attack=attack, batch=batch)
        with torch.no_grad():
            dets = anchor_head_predict(outs.cls_scores, outs.bbox_preds, outs.dir_preds,
                                       trainer.anchors, cfg.head)
        return dets, t_plan

    n = 0
    dumped = []
    for item in batches:
        # a bare PointCloudBatch is itself a NamedTuple: test it first
        batch, metas = (item, None) if isinstance(item, PointCloudBatch) else item
        t0 = time.perf_counter()
        (boxes, scores, labels, mask), plan_s = detect(batch)
        if tta:
            (bf, sf, lf, mf), plan_f = detect(_flip_y(batch))
            plan_s += plan_f
            bf = bf.clone()
            bf[..., 1] *= -1.0
            bf[..., 6] *= -1.0
            boxes, scores, labels, mask = merge(torch.cat([boxes, bf], 1),
                                                torch.cat([scores, sf], 1),
                                                torch.cat([labels, lf], 1),
                                                torch.cat([mask, mf], 1))
        boxes, scores, labels, mask = (t.cpu().numpy() for t in (boxes, scores, labels, mask))
        t1 = time.perf_counter()
        for b in range(batch.points.shape[0]):
            meta = metas[b] if metas is not None else {}
            if not meta.get("valid", True):
                continue
            metric.update_from_arrays(
                gt_boxes=np.asarray(batch.gt_boxes[b]), gt_labels=np.asarray(batch.gt_labels[b]),
                gt_mask=np.asarray(batch.gt_mask[b]), dt_boxes=boxes[b], dt_scores=scores[b],
                dt_labels=labels[b], dt_mask=mask[b], gt_difficulty=meta.get("gt_difficulty"),
                meta=meta)
            if dump_path is not None:
                m = np.asarray(mask[b], bool)
                dumped.append({"frame_id": meta.get("frame_id", str(n)),
                               "boxes_3d": boxes[b][m], "scores": scores[b][m],
                               "labels": labels[b][m]})
            n += 1
        t2 = time.perf_counter()
        batch_times.append({"plan_ms": plan_s * 1e3, "device_ms": (t1 - t0 - plan_s) * 1e3,
                            "metric_ms": (t2 - t1) * 1e3})
    t0 = time.perf_counter()
    results = metric.compute()
    if timings is not None:
        timings["batches"] = batch_times
        timings["ap_ms"] = (time.perf_counter() - t0) * 1e3
    results["num_frames"] = n
    if dump_path is not None:
        os.makedirs(os.path.dirname(dump_path) or ".", exist_ok=True)
        with open(dump_path, "wb") as f:
            pickle.dump(dumped, f)
        print(f"[dump] wrote {len(dumped)} frames of detections to {dump_path}", flush=True)
    return results

"""The serving forward and its export as a torch.export artifact (counterpart of robustpointclouds_tpu/cli/export.py).

`ServingModule(model, anchors, head)` is the serving graph:
`(points, mask[, plan]) -> (boxes, scores, labels, valid)`, the model
forward in eval mode (clean) — on a host plan, or self-contained with no
plan, the plan built on the device inside the request — then
  * SECOND (AdversarialVoxelNet) and PointPillars (AdversarialPointPillars,
    on the native pillar plan): anchor decode + rotated NMS, boxes [B, K, 7];
  * CenterPoint (AdversarialCenterPoint, `anchors` None): per-task heatmap
    top-k + circle NMS (models/center_detection.centerpoint_decode), boxes
    [B, K, 9] with the velocity.

`export_serving(model, state_dict, anchors, head)` runs that module eagerly:
`serve(points, mask, plan=None, attack=False)`; `attack=True` is the learned
adversary's evaluation-under-attack mode, an eager-only mode (the artifact
is clean, as JAX's export is).

`export_program(...)` exports the same module with torch.export, the weights
baked in, at a fixed batch size and point count; `save_exported` writes the
`.pt2` file and a `.json` meta file beside it; `load_exported(path)` gives a
callable of the same contract. The artifact's graph holds the three kernels
of the serving path as operators (rpc::sparse_conv_fwd, kernels/sparse_conv.py;
rpc::masked_bn_apply, kernels/masked_stats.py; the NMS keep-mask
rpc::greedy_keep, kernels/greedy_nms.py), so on the card the loaded program
launches them as the eager serve does. An artifact runs on the
device type it was exported on: export on the card to serve on the card,
with --cpu for the CPU.

Two variants, as in JAX:
  * default: self-contained (voxelisation and the index plan on the device);
  * --plan: plan-fed, its third input the family's native host plan
    (data/native_plan.py) as `plan_to_device` gives it.

Usage:
    python -m robustpointclouds_tpu_torch.cli.export <out.pt2> \\
        [--config CFG | --tiny] [--work-dir DIR | --load-from CKPT] \\
        [--batch-size N] [--num-points P] [--plan] [--cpu] [--allow-random-init]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..core.spans import span
from ..data.native_plan import build_pillar_plan_native, build_plan_native
from ..models.center_detection import CenterHeadConfig, centerpoint_decode
from ..models.centerpoint import AdversarialCenterPoint
from ..models.detection import AnchorHeadConfig, anchor_head_predict
from ..models.pointpillars import AdversarialPointPillars
from ..models.voxelnet import AdversarialVoxelNet, plan_to_device

Model = Union[AdversarialVoxelNet, AdversarialPointPillars, AdversarialCenterPoint]


class ServingModule(nn.Module):
    """The serving graph of one model: forward, then decode + NMS."""

    def __init__(self, model: Model, anchors: Optional[Any],
                 head: Union[AnchorHeadConfig, CenterHeadConfig]):
        super().__init__()
        self.model = model
        self.head = head
        self.centerpoint = isinstance(model, AdversarialCenterPoint)
        if not self.centerpoint:
            self.register_buffer("anchors", torch.as_tensor(np.asarray(
                anchors.cpu() if isinstance(anchors, torch.Tensor) else anchors, np.float32)))

    def forward(self, points: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                plan: Optional[Dict[str, Any]] = None, attack: bool = False):
        outs = self.model(points, mask, False, 100, attack, -1.0, plan)
        with span("rpc.decode"):
            if self.centerpoint:
                return centerpoint_decode(outs.task_preds, self.head)
            return anchor_head_predict(outs.cls_scores, outs.bbox_preds, outs.dir_preds,
                                       self.anchors, self.head)


def export_serving(model: Model, state_dict: Optional[Dict[str, torch.Tensor]],
                   anchors: Optional[np.ndarray], head: Union[AnchorHeadConfig, CenterHeadConfig],
                   device: Optional[Union[str, torch.device]] = None) -> Callable:
    """Bind weights, anchors (SECOND, PointPillars; None for CenterPoint) and the head
    config into a serving function that runs ServingModule eagerly.

    Runs on the card unless `device` asks for another; raises when no card
    is there and none was asked for. `state_dict=None` keeps the model's own
    weights.
    """
    dev = resolve_device(device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    module = ServingModule(model, anchors, head).to(dev).eval()

    @torch.no_grad()
    def serve(points, mask, plan=None, attack: bool = False):
        """`plan`: the native host plan's dict (numpy or on the device), or
        None: the plan is built from `points` / `mask` on the device."""
        with span("rpc.serve"):
            if plan is None:
                points = torch.as_tensor(points, device=dev)
                mask = torch.as_tensor(mask, device=dev)
            plan_t = None if plan is None else plan_to_device(plan, dev)
            return module(points, mask, plan_t, attack=attack)

    return serve


def num_point_features(model: Model) -> int:
    """Features a point carries at the model's input: 5 for CenterPoint's
    (x, y, z, intensity, sweep lag), else 4."""
    return getattr(model.cfg, "num_point_features", 4)


def native_plan(model: Model, points: np.ndarray, mask: np.ndarray) -> Dict[str, Any]:
    """The family's native host plan of a batch (no GTs): the plan-fed
    artifact's third input, before `plan_to_device`."""
    if isinstance(model, AdversarialPointPillars):
        return build_pillar_plan_native(points, mask, model.cfg.voxelizer, 4)
    return build_plan_native(points, mask, model.cfg.voxelizer, num_point_features(model))


def export_program(model: Model, anchors: Optional[Any],
                   head: Union[AnchorHeadConfig, CenterHeadConfig],
                   batch_size: int, num_points: int, use_plan: bool = False,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Tuple[torch.export.ExportedProgram, Dict[str, Any]]:
    """Export ServingModule's `(points, mask[, plan])` with the model's
    weights baked in (load a checkpoint into the model first), at
    B = batch_size and P = num_points, on the card unless `device` asks for
    another. Traced on zero frames (a plan-fed export on the
    native plan of zero frames); the graph has no data-dependent shape, so
    any frames of that size run it. Returns (ExportedProgram, meta)."""
    dev = resolve_device(device)
    module = ServingModule(model, anchors, head).to(dev).eval()
    nf = num_point_features(model)
    points = np.zeros((batch_size, num_points, nf), np.float32)
    mask = np.zeros((batch_size, num_points), bool)
    args: Tuple[Any, ...] = (torch.as_tensor(points, device=dev), torch.as_tensor(mask, device=dev))
    if use_plan:
        args += (plan_to_device(native_plan(model, points, mask), dev),)
    with torch.no_grad():
        ep = torch.export.export(module, args, strict=False)
    # the zero frames (and zero plan) traced on are not part of the artifact:
    # saved, the plan-fed one's would outweigh SECOND's weights
    ep.example_inputs = None
    cfg = model.cfg
    classes = getattr(cfg, "class_names", None) or [c for t in cfg.tasks for c in t]
    box_dim = 9 if module.centerpoint else 7
    meta = {
        "model_type": type(model).__name__,
        "batch_size": batch_size,
        "num_points": num_points,
        "plan_fed": use_plan,
        "classes": list(classes),
        "platforms": [dev.type],
        "torch_version": torch.__version__,
        "outputs": [f"boxes [B,N,{box_dim}]", "scores [B,N]", "labels [B,N]", "valid [B,N]"],
    }
    return ep, meta


def save_exported(ep: torch.export.ExportedProgram, meta: Dict[str, Any], path: str) -> int:
    """Write the artifact and `path + ".json"`; returns the artifact's bytes."""
    torch.export.save(ep, path)
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return os.path.getsize(path)


def _platform_present(platform: str) -> bool:
    return platform == "cpu" or (platform == "cuda" and torch.cuda.is_available())


def load_exported(path: str) -> Tuple[Callable, Dict[str, Any]]:
    """Load an artifact -> (callable, meta). The callable runs the exported
    graph under no_grad on the device type it was exported on. Raises,
    naming the device, when it is not there."""
    # registers rpc::sparse_conv_fwd, rpc::masked_bn_apply and
    # rpc::greedy_keep, which the graph names, before the graph is read
    from ..kernels import greedy_nms, masked_stats, sparse_conv  # noqa: F401

    meta: Dict[str, Any] = {}
    if os.path.isfile(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    for p in meta.get("platforms", []):
        if not _platform_present(p):
            raise RuntimeError(f"{path} was exported for {p}, and no {p} device is here")
    gm = torch.export.load(path).module()

    def call(*args):
        with torch.no_grad():
            return gm(*args)

    return call, meta


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Export the serving forward (torch.export)")
    p.add_argument("out", help="output artifact path (.pt2)")
    p.add_argument("--config", default=None,
                   help="model config file (model.type picks the family)")
    p.add_argument("--work-dir", default=None,
                   help="checkpoint dir to bake weights from (its latest epoch)")
    p.add_argument("--load-from", default=None,
                   help="port checkpoint (file or dir) or zoo .pth to bake weights from")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-points", type=int, default=20000)
    p.add_argument("--plan", action="store_true",
                   help="export the plan-fed variant (the native host plan as input)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--cpu", action="store_true", help="export for the CPU instead of the card")
    p.add_argument("--allow-random-init", action="store_true",
                   help="export fresh-init weights (smoke runs only)")
    from .common import parse_ported_args

    return parse_ported_args(p, argv, "export")


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the CLI; returns the artifact's meta."""
    args = parse_args(argv)
    from ..models.voxelnet import VoxelNetConfig
    from ..train.checkpoint import CheckpointManager, load_pretrained
    from ..train.loop import Trainer

    trainer_cls = Trainer
    if args.config:
        from ..core.builders import build_model_config
        from ..core.config import Config

        model_cfg = build_model_config(Config.fromfile(args.config))
        if type(model_cfg).__name__ == "CenterPointConfig":
            from ..train.centerpoint_loop import CenterPointTrainer

            trainer_cls = CenterPointTrainer
    elif args.tiny:
        from .common import tiny_voxelnet_cfg

        model_cfg = tiny_voxelnet_cfg()
    else:
        model_cfg = VoxelNetConfig()

    trainer = trainer_cls(model_cfg, device="cpu" if args.cpu else None)
    trainer.init_state(0)
    restored = False
    if args.load_from:
        load_pretrained(trainer, args.load_from)
        restored = True
    elif args.work_dir:
        mgr = CheckpointManager(args.work_dir)
        if mgr.latest_epoch() is not None:
            try:
                mgr.restore(trainer)
            except Exception as e:
                raise RuntimeError(
                    f"checkpoint in {args.work_dir!r} does not match the "
                    "exported model (e.g. a --tiny smoke run wrote it); "
                    f"point --work-dir at the right run: {e}"
                ) from e
            restored = True
    if not restored and not args.allow_random_init:
        raise RuntimeError(
            "no checkpoint given (--work-dir/--load-from) — refusing to "
            "export random weights (pass --allow-random-init for smoke runs)"
        )

    # CenterPointTrainer keeps no anchors
    ep, meta = export_program(trainer.model, getattr(trainer, "anchors", None),
                              model_cfg.head, args.batch_size, args.num_points, use_plan=args.plan,
                              device=trainer.device)
    nbytes = save_exported(ep, meta, args.out)
    print(f"[export] {args.out}: {nbytes / 1e6:.1f} MB, "
          f"platforms={meta['platforms']}, plan_fed={meta['plan_fed']}", flush=True)
    return meta


if __name__ == "__main__":
    main()

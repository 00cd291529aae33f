"""Config file -> model and train config builders (counterpart of robustpointclouds_tpu/core/builders.py).

Maps the dict schema of `configs/*.py` (core/config.Config) onto the static
NamedTuple / dataclass configs the port's models and trainer take, so that
`--cfg-options model.adversary_cfg.sensor_error_bound=0.3` really changes
the built model: the SECOND/VoxelNet, CenterPoint and PointPillars families,
the dispatch on `model.type` (`build_model_config`) and the train config.
As in the JAX package, `StrongAdversarialVoxelNet` maps to a plain
VoxelNetConfig: the strong family trains through its own entry point
(cli/train_kitti_adversarial_strong.py), which builds StrongVoxelNetConfig
from its defaults.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .config import Config


def _as_tuple(v, depth: int = 1):
    if v is None:
        return None
    if depth <= 1:
        return tuple(v)
    return tuple(_as_tuple(x, depth - 1) for x in v)


def _adversary_dict(cfg_model: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    adv = cfg_model.get("adversary_cfg", cfg_model.get("adversary"))
    if adv is None:
        return None
    out = {}
    for key in ("sensor_error_bound", "use_spatial_attention", "hidden_channels"):
        if key in adv:
            v = adv[key]
            out[key] = tuple(v) if isinstance(v, (list, tuple)) else v
    return out


def build_voxelizer(vz: Dict[str, Any]):
    from ..ops.voxelize import VoxelizerConfig

    return VoxelizerConfig(
        point_cloud_range=_as_tuple(vz["point_cloud_range"]),
        voxel_size=_as_tuple(vz["voxel_size"]),
        max_points_per_voxel=int(vz.get("max_points_per_voxel", 5)),
        max_voxels=int(vz.get("max_voxels", 16000)),
    )


def build_voxelnet_config(cfg: Config):
    """configs/_base_/kitti-3d-3class.py schema -> models.voxelnet.VoxelNetConfig."""
    from ..models.voxelnet import VoxelNetConfig

    m = cfg.get("model", {})
    head_d = m.get("bbox_head", {})
    base = VoxelNetConfig()
    return VoxelNetConfig(
        voxelizer=build_voxelizer(m.get("voxelizer", {})) if m.get("voxelizer") else base.voxelizer,
        num_classes=int(head_d.get("num_classes", 3)),
        class_names=_as_tuple(cfg.get("class_names", base.class_names)),
        anchor_ranges=_as_tuple(head_d.get("anchor_ranges", base.anchor_ranges), depth=2),
        anchor_sizes=_as_tuple(head_d.get("anchor_sizes", base.anchor_sizes), depth=2),
        anchor_rotations=_as_tuple(head_d.get("anchor_rotations", base.anchor_rotations)),
        head=_build_anchor_head(cfg),
        adversary=_adversary_dict(m),
        adversarial_loss_weight=float(m.get("adversarial_loss_weight",
                                            base.adversarial_loss_weight)),
        regularization_weight=float(m.get("regularization_weight", base.regularization_weight)),
        adversary_start_epoch=int(m.get("adversary_start_epoch", base.adversary_start_epoch)),
    )


def build_centerpoint_config(cfg: Config):
    """configs/adversarial/adversarial-centerpoint_nuscenes.py schema ->
    models.centerpoint.CenterPointConfig."""
    from ..models.centerpoint import CenterPointConfig

    m = cfg.get("model", {})
    base = CenterPointConfig()
    tasks = m.get("tasks")
    return CenterPointConfig(
        voxelizer=build_voxelizer(m.get("voxelizer", {})) if m.get("voxelizer") else base.voxelizer,
        num_point_features=int(m.get("num_point_features", base.num_point_features)),
        tasks=_as_tuple(tasks, depth=2) if tasks else base.tasks,
        head=base.head if not tasks else base.head._replace(tasks=_as_tuple(tasks, depth=2)),
        adversary=_adversary_dict(m),
        adversarial_loss_weight=float(m.get("adversarial_loss_weight",
                                            base.adversarial_loss_weight)),
        regularization_weight=float(m.get("regularization_weight", base.regularization_weight)),
        adversary_start_epoch=int(m.get("adversary_start_epoch", base.adversary_start_epoch)),
        encoder_channels=(_as_tuple(m["encoder_channels"], depth=2)
                          if m.get("encoder_channels") else base.encoder_channels),
        residual_encoder=bool(m.get("residual_encoder", base.residual_encoder)),
        use_dcn_head=bool(m.get("use_dcn_head", base.use_dcn_head)),
    )


def build_pointpillars_config(cfg: Config):
    """The pillar family's schema (the voxelnet schema's keys) ->
    models.pointpillars.PointPillarsConfig."""
    from ..models.pointpillars import PointPillarsConfig

    m = cfg.get("model", {})
    head_d = m.get("bbox_head", {})
    base = PointPillarsConfig()
    return PointPillarsConfig(
        voxelizer=build_voxelizer(m["voxelizer"]) if m.get("voxelizer") else base.voxelizer,
        num_classes=int(head_d.get("num_classes", 3)),
        head=_build_anchor_head(cfg),
        class_names=_as_tuple(cfg.get("class_names", base.class_names)),
        anchor_ranges=_as_tuple(head_d.get("anchor_ranges", base.anchor_ranges), depth=2),
        anchor_sizes=_as_tuple(head_d.get("anchor_sizes", base.anchor_sizes), depth=2),
        anchor_rotations=_as_tuple(head_d.get("anchor_rotations", base.anchor_rotations)),
        adversary=_adversary_dict(m),
        adversarial_loss_weight=float(m.get("adversarial_loss_weight",
                                            base.adversarial_loss_weight)),
        regularization_weight=float(m.get("regularization_weight", base.regularization_weight)),
        adversary_start_epoch=int(m.get("adversary_start_epoch", base.adversary_start_epoch)),
    )


def build_model_config(cfg: Config):
    """Dispatch on model.type (the registry names of the config files)."""
    mtype = cfg.get("model", {}).get("type", "AdversarialVoxelNet")
    if mtype in ("AdversarialVoxelNet", "VoxelNet", "StrongAdversarialVoxelNet"):
        return build_voxelnet_config(cfg)
    if mtype in ("AdversarialCenterPoint", "CenterPoint"):
        return build_centerpoint_config(cfg)
    if mtype in ("AdversarialPointPillars", "PointPillars"):
        return build_pointpillars_config(cfg)
    raise ValueError(f"unknown model type {mtype!r}")


def build_train_config(cfg: Config, **overrides):
    """The config's `optim` and schedule keys -> train.loop.TrainConfig.
    `overrides` win (CLI flags such as --freeze-detector)."""
    from ..train.loop import TrainConfig

    o = cfg.get("optim", {})
    m = cfg.get("model", {})
    pgd = cfg.get("pgd_adversary", {})
    base = TrainConfig()
    kwargs: Dict[str, Any] = dict(
        learning_rate=float(o.get("lr", base.learning_rate)),
        adversary_lr_mult=float(o.get("adversary_lr_mult", base.adversary_lr_mult)),
        weight_decay=float(o.get("weight_decay", base.weight_decay)),
        grad_clip_norm=float(o.get("clip_grad_norm", base.grad_clip_norm)),
        warmup_iters=int(o.get("warmup_iters", base.warmup_iters)),
        warmup_start_factor=float(o.get("warmup_start_factor", base.warmup_start_factor)),
        eta_min_factor=float(o.get("eta_min_factor", base.eta_min_factor)),
        max_epochs=int(cfg.get("max_epochs", base.max_epochs)),
        adversarial_loss_weight=float(m.get("adversarial_loss_weight",
                                            base.adversarial_loss_weight)),
        regularization_weight=float(m.get("regularization_weight", base.regularization_weight)),
        # PGD adversarial training: `pgd_adversary = dict(steps=K, rel_step=2.5)`
        pgd_steps=int(pgd.get("steps", base.pgd_steps)),
        pgd_rel_step=float(pgd.get("rel_step", base.pgd_rel_step)),
    )
    kwargs.update(overrides)
    return TrainConfig(**kwargs)


def _build_anchor_head(cfg: Config):
    """model.bbox_head / train_cfg / test_cfg keys -> AnchorHeadConfig."""
    from ..models.detection import AnchorHeadConfig

    m = cfg.get("model", {})
    head_d = m.get("bbox_head", {})
    train_d = m.get("train_cfg", {})
    test_d = m.get("test_cfg", {})
    base = AnchorHeadConfig()
    return AnchorHeadConfig(
        num_classes=int(head_d.get("num_classes", 3)),
        pos_iou_thr=_as_tuple(train_d.get("pos_iou_thr", base.pos_iou_thr)),
        neg_iou_thr=_as_tuple(train_d.get("neg_iou_thr", base.neg_iou_thr)),
        min_pos_iou=_as_tuple(train_d.get("min_pos_iou", base.min_pos_iou)),
        diff_rad_by_sin=bool(head_d.get("diff_rad_by_sin", True)),
        score_thr=float(test_d.get("score_thr", 0.1)),
        nms_pre=int(test_d.get("nms_pre", 100)),
        nms_iou_thr=float(test_d.get("nms_thr", 0.01)),
        max_num=int(test_d.get("max_num", 50)),
        use_rotate_nms=bool(test_d.get("use_rotate_nms", True)),
    )

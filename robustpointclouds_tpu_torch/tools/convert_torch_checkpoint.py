"""Warm starts from mmdet3d zoo checkpoints (counterpart of robustpointclouds_tpu/tools/convert_torch_checkpoint.py).

The reference warm-starts every run from a zoo checkpoint (`load_from=...`,
adversarial-second_hv_secfpn_8xb6-80e_kitti-3d-3class.py:167,
adversarial-centerpoint_voxel-nuscenes.py:88). The port names its modules by
the mmdet3d state_dict keys and keeps spconv2's (out, kz, ky, kx, in) sparse
layout, so a zoo state_dict maps onto the port's own keys almost one for
one. This module takes, renames, transposes and refuses exactly what the JAX
package's converter does, key by key:

  * sparse kernels: spconv2 (out, kz, ky, kx, in) as they are, spconv1
    (kz, ky, kx, in, out) transposed to it; a shape that matches neither or
    both raises;
  * Conv2d, Linear and the stride > 1 ConvTranspose2d as they are (the JAX
    converter's spatial flip of a transposed conv and the weight bridge's
    flip back, tools/convert.py, cancel);
  * the stride-1 1x1 neck deblock, oriented against the backbone stage's
    out-width: (in, out, 1, 1) as it is, (out, in, 1, 1) transposed, a
    square weight taken as (in, out, 1, 1), anything else raises;
  * BatchNorm weight / bias / running_mean / running_var (never
    num_batches_tracked, which the JAX state lacks);
  * the DCN CenterHead's `feature_adapt_{cls,reg}` into the port's `.dcn`
    (no adaptation BatchNorm: JAX loads none), the heatmap and regression
    branches into `task_heads.{t}.cls_head` / `.task_head.{name}` of the DCN
    head or `.heatmap` / `.{name}` of the plain one.

The reference's gaps are kept, as the port follows JAX (ROADMAP.md §3):
the backbone scan stops at mmdet3d's parameter-less ReLU, so only
`backbone.blocks.{s}.0` / `.1` of each stage load; no z-fold channel
permutation and no padding change is applied.

A converted state is a dict {port key: numpy array}; each key is one
leaf of the JAX converter's trees, so `merge_into_state_dict` counts loaded
and skipped tensors in the JAX converter's units.

Usage (runs on the card unless --cpu):
    python -m robustpointclouds_tpu_torch.tools.convert_torch_checkpoint \
        checkpoints/second.pth --out work_dirs/converted [--cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# the mmdet3d prefixes of the SECOND sparse encoder's conv + BN blocks: the
# port's modules carry the same names
_SPARSE_BLOCKS = [
    "middle_encoder.conv_input",
    "middle_encoder.encoder_layers.encoder_layer1.0",
    "middle_encoder.encoder_layers.encoder_layer2.0",
    "middle_encoder.encoder_layers.encoder_layer2.1",
    "middle_encoder.encoder_layers.encoder_layer2.2",
    "middle_encoder.encoder_layers.encoder_layer3.0",
    "middle_encoder.encoder_layers.encoder_layer3.1",
    "middle_encoder.encoder_layers.encoder_layer3.2",
    "middle_encoder.encoder_layers.encoder_layer4.0",
    "middle_encoder.encoder_layers.encoder_layer4.1",
    "middle_encoder.encoder_layers.encoder_layer4.2",
    "middle_encoder.conv_out",
]

_STATS = ("running_mean", "running_var")

Converted = Dict[str, np.ndarray]


def convert_sparse_conv_weight(w: np.ndarray) -> np.ndarray:
    """spconv kernel -> the port's spconv2 layout (out, kz, ky, kx, in).

    Accepts (out, kz, ky, kx, in) [spconv2] or (kz, ky, kx, in, out)
    [spconv1], told apart as the JAX converter does: every SECOND kernel dim
    is <= 3 and every channel dim >= 4, and a shape that matches neither or
    both layouts raises."""
    if w.ndim != 5:
        raise ValueError(f"expected 5D sparse conv weight, got {w.shape}")
    ks = w.shape
    spatial_mid = all(d <= 3 for d in ks[1:4]) and ks[0] > 3  # spconv2
    spatial_lead = all(d <= 3 for d in ks[0:3]) and ks[3] > 3  # spconv1
    if spatial_mid == spatial_lead:
        raise ValueError(
            f"ambiguous sparse conv weight layout for shape {ks}: cannot "
            "tell spconv2 (out,kz,ky,kx,in) from spconv1 (kz,ky,kx,in,out)")
    return w if spatial_mid else np.transpose(w, (4, 0, 1, 2, 3))


def _bn(sd: Converted, src: str, out: Converted, dst: str):
    for name in ("weight", "bias", *_STATS):
        out[f"{dst}.{name}"] = sd[f"{src}.{name}"]


def convert_second_state_dict(sd: Dict[str, np.ndarray]) -> Converted:
    """mmdet3d SECOND/VoxelNet state_dict -> the port's keys: the sparse
    encoder, conv0 + BN of each backbone stage, the SECONDFPN deblocks and
    the Anchor3DHead convs."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    out: Converted = {}
    for blk in _SPARSE_BLOCKS:
        wkey = f"{blk}.0.weight"
        if wkey not in sd:
            continue
        out[wkey] = convert_sparse_conv_weight(sd[wkey])
        _bn(sd, f"{blk}.1", out, f"{blk}.1")

    # SECOND backbone: blocks.{s}.{j}, j = 0 conv, 1 BN, 2 ReLU, 3 conv...; the
    # scan of each stage stops at the ReLU, which has no tensors (the JAX
    # converter's gap, kept)
    s = 0
    while f"backbone.blocks.{s}.0.weight" in sd:
        j = 0
        while f"backbone.blocks.{s}.{j}.weight" in sd or (
                f"backbone.blocks.{s}.{j}.running_mean" in sd):
            key = f"backbone.blocks.{s}.{j}"
            if f"{key}.running_mean" in sd:
                _bn(sd, key, out, key)
            elif sd[f"{key}.weight"].ndim == 4:
                out[f"{key}.weight"] = sd[f"{key}.weight"]
            j += 1
        s += 1

    # SECONDFPN: deblocks.{i}.0 (upsample), .1 (BN). kernel_size == stride,
    # so k > 1 is a ConvTranspose2d; a 1x1 weight is oriented against the
    # backbone stage's out-width
    i = 0
    while f"neck.deblocks.{i}.0.weight" in sd:
        key = f"neck.deblocks.{i}.0.weight"
        w = sd[key]
        if w.shape[2] > 1:
            out[key] = w
        else:
            bk = f"backbone.blocks.{i}.0.weight"
            cin = sd[bk].shape[0] if bk in sd else None  # stage out-width
            if cin is not None and w.shape[0] == cin and w.shape[1] != cin:
                out[key] = w  # ConvTranspose2d(k=1, s=1): (in, out, 1, 1)
            elif cin is not None and w.shape[1] == cin and w.shape[0] != cin:
                out[key] = np.transpose(w, (1, 0, 2, 3))  # Conv2d: (out, in, 1, 1)
            elif w.shape[0] == w.shape[1]:
                out[key] = w  # square: mmdet3d's default, the ConvTranspose orientation
            else:
                raise ValueError(
                    f"cannot orient 1x1 neck upsample deblocks.{i}.0 with "
                    f"shape {w.shape}: expected one side == backbone stage "
                    f"out-width {cin}")
        _bn(sd, f"neck.deblocks.{i}.1", out, f"neck.deblocks.{i}.1")
        i += 1

    for name in ("conv_cls", "conv_reg", "conv_dir_cls"):
        if f"bbox_head.{name}.weight" in sd:
            out.update({k: sd[k] for k in (f"bbox_head.{name}.weight", f"bbox_head.{name}.bias")
                        if k in sd})
    return out


def convert_centerpoint_state_dict(sd: Dict[str, np.ndarray], dcn_head: bool = True) -> Converted:
    """mmdet3d CenterPoint (pts_* keys, the zoo
    centerpoint_01voxel_second_secfpn_dcn_circlenms layout) -> the port's
    keys: the backbone and neck through the SECOND mapping under `pts_`,
    conv_input / conv_out, the residual stages' SparseBasicBlocks
    (conv1/bn1/conv2/bn2) and strided blocks (.0 / .1), and the CenterHead:
    its shared conv, and per task the DCN adaptations' weight and
    conv_offset, the heatmap branch and the regression branches.

    `dcn_head`: the target model's head. The DCN head's branches are
    `cls_head` / `task_head.{name}` and its adaptations `feature_adapt_*.dcn`;
    the plain head's are `heatmap` / `{name}` and it has no adaptations, so
    their keys are skipped as missing, as in JAX."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    stripped = {k[len("pts_"):]: v for k, v in sd.items()
                if k.startswith(("pts_backbone.", "pts_neck."))}
    out: Converted = {f"pts_{k}": v for k, v in convert_second_state_dict(stripped).items()}

    enc = "pts_middle_encoder"
    for blk in ("conv_input", "conv_out"):
        wkey = f"{enc}.{blk}.0.weight"
        if wkey in sd:
            out[wkey] = convert_sparse_conv_weight(sd[wkey])
            _bn(sd, f"{enc}.{blk}.1", out, f"{enc}.{blk}.1")
    for s in range(4):
        j = 0
        while True:
            base = f"{enc}.encoder_layers.encoder_layer{s + 1}.{j}"
            if f"{base}.conv1.weight" in sd:
                for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
                    out[f"{base}.{conv}.weight"] = convert_sparse_conv_weight(
                        sd[f"{base}.{conv}.weight"])
                    _bn(sd, f"{base}.{bn}", out, f"{base}.{bn}")
            elif f"{base}.0.weight" in sd:
                out[f"{base}.0.weight"] = convert_sparse_conv_weight(sd[f"{base}.0.weight"])
                _bn(sd, f"{base}.1", out, f"{base}.1")
            else:
                break
            j += 1

    head = "pts_bbox_head"
    if f"{head}.shared_conv.conv.weight" in sd:
        out[f"{head}.shared_conv.conv.weight"] = sd[f"{head}.shared_conv.conv.weight"]
        _bn(sd, f"{head}.shared_conv.bn", out, f"{head}.shared_conv.bn")
    t = 0
    while f"{head}.task_heads.{t}.cls_head.0.conv.weight" in sd:
        src = f"{head}.task_heads.{t}"
        for branch in ("cls", "reg"):
            a = f"{src}.feature_adapt_{branch}"
            if f"{a}.weight" not in sd:
                continue
            out[f"{a}.dcn.weight"] = sd[f"{a}.weight"]
            for p in ("weight", "bias"):
                out[f"{a}.dcn.conv_offset.{p}"] = sd[f"{a}.conv_offset.{p}"]
        heads = [("cls_head", "cls_head" if dcn_head else "heatmap")]
        heads += [(f"task_head.{n}", f"task_head.{n}" if dcn_head else n)
                  for n in ("reg", "height", "dim", "rot", "vel")
                  if f"{src}.task_head.{n}.0.conv.weight" in sd]
        for name, dst in heads:
            out[f"{src}.{dst}.0.conv.weight"] = sd[f"{src}.{name}.0.conv.weight"]
            _bn(sd, f"{src}.{name}.0.bn", out, f"{src}.{dst}.0.bn")
            for p in ("weight", "bias"):
                out[f"{src}.{dst}.1.{p}"] = sd[f"{src}.{name}.1.{p}"]
        t += 1
    return out


def convert_pointpillars_state_dict(sd: Dict[str, np.ndarray]) -> Converted:
    """mmdet3d PointPillars (pointpillars_hv_secfpn) -> the port's keys: the
    PFN's Linear [64, 9] and its BatchNorm1d `.norm`, then the SECOND
    backbone / neck / head mapping."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    out = convert_second_state_dict(sd)
    pfn = "voxel_encoder.pfn_layers.0"
    if f"{pfn}.linear.weight" in sd:
        out[f"{pfn}.linear.weight"] = sd[f"{pfn}.linear.weight"]
        _bn(sd, f"{pfn}.norm", out, f"{pfn}.norm")
    return out


def detect_state_dict_layout(sd: Dict[str, np.ndarray]) -> str:
    """Which zoo family a state dict belongs to: 'centerpoint' (pts_* keys),
    'pointpillars' (PFN voxel encoder) or 'second' (sparse middle encoder).
    A pillar-variant CenterPoint and an unrecognised layout raise: a
    family-mismatched converter would find none of its keys."""
    if any(k.startswith("pts_") for k in sd):
        if any(k.startswith("pts_voxel_encoder.pfn_layers.") for k in sd):
            raise ValueError(
                "pillar-variant CenterPoint checkpoints "
                "(pts_voxel_encoder.pfn_layers.*) are not supported — this "
                "framework's CenterPoint is the 01voxel sparse-encoder "
                "variant the reference warm-starts from")
        return "centerpoint"
    if any(k.startswith("voxel_encoder.pfn_layers.") for k in sd):
        return "pointpillars"
    if any(k.startswith("middle_encoder.") for k in sd):
        return "second"
    raise ValueError(
        "unrecognized checkpoint layout: expected mmdet3d keys under pts_* "
        "(CenterPoint), voxel_encoder.pfn_layers.* (PointPillars) or "
        f"middle_encoder.* (SECOND); got keys like {sorted(sd)[:5]}")


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """The state_dict of an mmdet3d `.pth` as numpy arrays. It is read with
    `weights_only=False`, as the JAX package reads it: unpickling runs code
    the file carries, so load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in sd.items()}


def _missing_module(key: str, modules) -> Optional[str]:
    """The outermost module on `key`'s path the model lacks, else None."""
    parts = key.split(".")
    for n in range(1, len(parts)):
        prefix = ".".join(parts[:n])
        if prefix not in modules:
            return prefix
    return None


def merge_into_state_dict(model: torch.nn.Module, converted: Converted,
                          strict_prefixes: Sequence[str] = (),
                          zero_error: Optional[str] = None) -> Tuple[List[str], List[str]]:
    """Copy the converted tensors into `model`'s own parameters and buffers.

    Returns (loaded keys, skipped reports). A key the model lacks is skipped
    once per missing module and tree (parameters, statistics), as the JAX
    converter skips a missing subtree once in each of its trees; a shape
    mismatch is skipped per key. A skip under any of `strict_prefixes`
    raises "warm start dropped required tensors"; with `zero_error`, loading
    no parameter raises ValueError(zero_error). Both raise before anything
    is copied. Values are cast to the target's dtype and copied on its
    device; num_batches_tracked is left as it is."""
    target = model.state_dict(keep_vars=True)
    modules = dict(model.named_modules())
    params = {k for k, _ in model.named_parameters()}
    loaded: List[str] = []
    skipped: List[str] = []
    missing = set()
    for key, value in converted.items():
        tgt = target.get(key)
        if tgt is None:
            group = _missing_module(key, modules) or key
            tree = "stats" if key.endswith(_STATS) else "params"
            if (group, tree) not in missing:
                missing.add((group, tree))
                skipped.append(f"{group} (missing in model)")
        elif tuple(tgt.shape) != tuple(value.shape):
            skipped.append(f"{key} (shape {tuple(value.shape)} vs {tuple(tgt.shape)})")
        else:
            loaded.append(key)
    bad = [s for s in skipped if s.startswith(tuple(strict_prefixes))] if strict_prefixes else []
    if bad:
        raise ValueError("warm start dropped required tensors: " + "; ".join(bad[:10]))
    if zero_error is not None and not any(k in params for k in loaded):
        raise ValueError(zero_error)
    with torch.no_grad():
        for key in loaded:
            target[key].copy_(torch.from_numpy(np.ascontiguousarray(converted[key])))
    return loaded, skipped


def main(argv: Optional[List[str]] = None) -> Tuple[List[str], List[str]]:
    """Warm-start the full-width SECOND Trainer from a `.pth` and save it as
    a port checkpoint (`<out>/epoch_0.pt`); returns (loaded, skipped)."""
    p = argparse.ArgumentParser(description="Convert an mmdet3d SECOND checkpoint")
    p.add_argument("checkpoint", help=".pth file")
    p.add_argument("--out", default="work_dirs/converted")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)

    from ..models.voxelnet import VoxelNetConfig
    from ..train.checkpoint import CheckpointManager
    from ..train.loop import TrainConfig, Trainer

    trainer = Trainer(VoxelNetConfig(), TrainConfig(), device="cpu" if args.cpu else None)
    trainer.init_state(0)
    converted = convert_second_state_dict(load_torch_checkpoint(args.checkpoint))
    loaded, skipped = merge_into_state_dict(trainer.model, converted,
                                            strict_prefixes=("middle_encoder",))
    print(f"loaded {len(loaded)} tensors; skipped {len(skipped)}", flush=True)
    for s in skipped[:20]:
        print("  skip:", s)
    CheckpointManager(args.out).save(0, trainer)
    print(f"saved converted checkpoint to {args.out}", flush=True)
    return loaded, skipped


if __name__ == "__main__":
    main()

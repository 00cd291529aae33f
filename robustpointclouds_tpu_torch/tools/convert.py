"""Weight bridge: the JAX package's (params, batch_stats) trees -> the port's state_dict.

The port names its modules by the mmdet3d state_dict keys and keeps
spconv2's (out, kz, ky, kx, in) sparse-weight layout, so this bridge is the
inverse of the JAX package's zoo converter
(robustpointclouds_tpu/tools/convert_torch_checkpoint.convert_second_state_dict):
  * img2col sparse kernels [K*Cin, Cout] -> (Cout, kz, ky, kx, Cin);
  * flax Conv (kh, kw, in, out) -> Conv2d (out, in, kh, kw);
  * flax ConvTranspose (kh, kw, in, out) -> ConvTranspose2d (in, out, kh, kw),
    spatially flipped (torch's transposed conv correlates with the flipped
    kernel relative to flax's);
  * the stride-1 1x1 deblock (a flax Conv) -> a 1x1 ConvTranspose2d
    (in, out, 1, 1), the orientation mmdet3d builds;
  * BatchNorm {scale, bias} + {mean, var} -> weight/bias/running_mean/
    running_var (+ num_batches_tracked 0).
The VoxelPerturber, which the zoo map lacks, maps `mlp_i`/`mlp_out`/
`attn_0`/`attn_1` Dense kernels (in, out) to Linear weights (out, in) and
`bn_i` as BatchNorm; the StrongVoxelPerturber's `enc_i`/`bottleneck`/
`dec_i`/`out`/`attn_*` likewise, its `*_bn*` as BatchNorm
(`perturber_to_state_dict` serves both), and `jax_to_state_dict` maps the
whole JAX StrongAdversarialVoxelNet too (its SECOND body carries the same
names, its adversary is the strong one). `centerpoint_to_state_dict` does the same for the JAX
AdversarialCenterPoint: the residual encoder's `stage{i}_res{j}` blocks
(conv1/bn1/conv2/bn2) and `stage{i}_down` convs, or the plain encoder's
`stage{i}_subm{j}` / `stage{i}_down` convs, the backbone and neck
under `pts_`, and the CenterHead (flax convs -> Conv2d, the DCN kernel ->
mmcv's grouped [Cout, Cin/g, 3, 3] weight). `pointpillars_to_state_dict`
maps the JAX AdversarialPointPillars: the PillarFeatureNet's `pfn/Dense_0`
kernel (in, out) into `voxel_encoder.pfn_layers.0.linear` (out, in) and its
MaskedBatchNorm into `.norm`, then the dense body, the head and the
adversary as for SECOND. Inputs are nested mappings of numpy-convertible
arrays.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# (mmdet3d module prefix, JAX module name under middle_encoder)
_SPARSE_BLOCKS = [
    ("middle_encoder.conv_input", "conv_input"),
    ("middle_encoder.encoder_layers.encoder_layer1.0", "stage0_subm0"),
    ("middle_encoder.encoder_layers.encoder_layer2.0", "stage1_down"),
    ("middle_encoder.encoder_layers.encoder_layer2.1", "stage1_subm1"),
    ("middle_encoder.encoder_layers.encoder_layer2.2", "stage1_subm2"),
    ("middle_encoder.encoder_layers.encoder_layer3.0", "stage2_down"),
    ("middle_encoder.encoder_layers.encoder_layer3.1", "stage2_subm1"),
    ("middle_encoder.encoder_layers.encoder_layer3.2", "stage2_subm2"),
    ("middle_encoder.encoder_layers.encoder_layer4.0", "stage3_down"),
    ("middle_encoder.encoder_layers.encoder_layer4.1", "stage3_subm1"),
    ("middle_encoder.encoder_layers.encoder_layer4.2", "stage3_subm2"),
    ("middle_encoder.conv_out", "conv_out"),
]


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def sparse_kernel_to_spconv(kernel, kernel_size) -> np.ndarray:
    """img2col [K*Cin, Cout] (tap order z, y, x) -> spconv2 (Cout, kz, ky, kx, Cin)."""
    kernel = _np(kernel)
    kz, ky, kx = kernel_size
    cin = kernel.shape[0] // (kz * ky * kx)
    return kernel.reshape(kz, ky, kx, cin, kernel.shape[1]).transpose(4, 0, 1, 2, 3)


def _bn(sd: Dict[str, np.ndarray], prefix: str, p: Mapping, s: Mapping):
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])
    sd[f"{prefix}.running_mean"] = _np(s["mean"])
    sd[f"{prefix}.running_var"] = _np(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _conv2d(kernel) -> np.ndarray:
    """flax Conv (kh, kw, in, out) -> Conv2d (out, in, kh, kw)."""
    return _np(kernel).transpose(3, 2, 0, 1)


def _dense_body(sd: Dict[str, np.ndarray], prefix: str, params: Mapping, batch_stats: Mapping):
    """SECONDBackbone + SECONDFPN: JAX `{prefix}backbone` / `{prefix}neck`
    -> the port's `{prefix}backbone.blocks` / `{prefix}neck.deblocks`."""
    bp, bs = params[f"{prefix}backbone"], batch_stats[f"{prefix}backbone"]
    s = 0
    while f"stage{s}_conv0" in bp:
        i = 0
        while f"stage{s}_conv{i}" in bp:
            name = f"stage{s}_conv{i}"
            sd[f"{prefix}backbone.blocks.{s}.{3 * i}.weight"] = _conv2d(bp[name]["Conv_0"]["kernel"])
            _bn(sd, f"{prefix}backbone.blocks.{s}.{3 * i + 1}", bp[name]["BatchNorm_0"],
                bs[name]["BatchNorm_0"])
            i += 1
        s += 1

    np_, ns = params[f"{prefix}neck"], batch_stats[f"{prefix}neck"]
    i = 0
    while f"deblock{i}_bn" in np_:
        if f"deblock{i}_deconv" in np_:
            k = _np(np_[f"deblock{i}_deconv"]["kernel"])[::-1, ::-1]
        else:  # stride-1 1x1 Conv == 1x1 ConvTranspose2d with (in, out) weight
            k = _np(np_[f"deblock{i}_conv"]["kernel"])
        sd[f"{prefix}neck.deblocks.{i}.0.weight"] = k.transpose(2, 3, 0, 1)
        _bn(sd, f"{prefix}neck.deblocks.{i}.1", np_[f"deblock{i}_bn"], ns[f"deblock{i}_bn"])
        i += 1


def _anchor_model_tail(sd: Dict[str, np.ndarray], params: Mapping,
                       batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """The dense body, the Anchor3DHead and the adversary of an anchor-head
    model added to `sd`, as tensors."""
    _dense_body(sd, "", params, batch_stats)
    for name in ("conv_cls", "conv_reg", "conv_dir_cls"):
        p = params["bbox_head"][name]
        sd[f"bbox_head.{name}.weight"] = _conv2d(p["kernel"])
        sd[f"bbox_head.{name}.bias"] = _np(p["bias"])

    out = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    if "adversary" in params:
        adv = perturber_to_state_dict(params["adversary"], batch_stats["adversary"])
        out.update({f"adversary.{k}": v for k, v in adv.items()})
    return out


def jax_to_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """(params, batch_stats) of the JAX AdversarialVoxelNet or
    StrongAdversarialVoxelNet -> port state_dict."""
    sd: Dict[str, np.ndarray] = {}
    me, mes = params["middle_encoder"], batch_stats["middle_encoder"]
    for prefix, name in _SPARSE_BLOCKS:
        ks = (3, 1, 1) if name == "conv_out" else (3, 3, 3)
        sd[f"{prefix}.0.weight"] = sparse_kernel_to_spconv(me[name]["kernel"], ks)
        _bn(sd, f"{prefix}.1", me[name]["MaskedBatchNorm_0"], mes[name]["MaskedBatchNorm_0"])
    return _anchor_model_tail(sd, params, batch_stats)


def pointpillars_to_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """(params, batch_stats) of the JAX AdversarialPointPillars -> port state_dict."""
    sd: Dict[str, np.ndarray] = {}
    pfn = "voxel_encoder.pfn_layers.0"
    sd[f"{pfn}.linear.weight"] = _np(params["pfn"]["Dense_0"]["kernel"]).T
    _bn(sd, f"{pfn}.norm", params["pfn"]["MaskedBatchNorm_0"],
        batch_stats["pfn"]["MaskedBatchNorm_0"])
    return _anchor_model_tail(sd, params, batch_stats)


def perturber_to_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX VoxelPerturber's or StrongVoxelPerturber's trees -> the port
    module's state_dict: a module with batch statistics is a BatchNorm, every
    other a Dense."""
    sd: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        if name in batch_stats:
            _bn(sd, name, p, batch_stats[name])
        else:
            sd[f"{name}.weight"] = _np(p["kernel"]).T
            sd[f"{name}.bias"] = _np(p["bias"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _sep_head(sd: Dict[str, np.ndarray], prefix: str, p: Mapping, s: Mapping):
    """A JAX _SeparateHead (conv0, bn0, out) -> the port's `{prefix}.{0.conv,0.bn,1}`."""
    sd[f"{prefix}.0.conv.weight"] = _conv2d(p["conv0"]["kernel"])
    _bn(sd, f"{prefix}.0.bn", p["bn0"], s["bn0"])
    sd[f"{prefix}.1.weight"] = _conv2d(p["out"]["kernel"])
    sd[f"{prefix}.1.bias"] = _np(p["out"]["bias"])


def centerpoint_to_state_dict(params: Mapping, batch_stats: Mapping,
                              encoder_channels=((16, 16, 32), (32, 32, 64), (64, 64, 128),
                                                (128, 128))) -> Dict[str, torch.Tensor]:
    """(params, batch_stats) of the JAX AdversarialCenterPoint (its encoder
    of `encoder_channels`, residual or plain as its tree holds) -> the
    port's state_dict."""
    sd: Dict[str, np.ndarray] = {}
    me, mes = params["pts_middle_encoder"], batch_stats["pts_middle_encoder"]
    enc = "pts_middle_encoder"

    def block(prefix, name, ks=(3, 3, 3)):
        sd[f"{prefix}.0.weight"] = sparse_kernel_to_spconv(me[name]["kernel"], ks)
        _bn(sd, f"{prefix}.1", me[name]["MaskedBatchNorm_0"], mes[name]["MaskedBatchNorm_0"])

    block(f"{enc}.conv_input", "conv_input")
    n_stages = len(encoder_channels)
    residual = "stage0_res0" in me
    for i, stage in enumerate(encoder_channels):
        layer = f"{enc}.encoder_layers.encoder_layer{i + 1}"
        if not residual:
            # the conv_module layout: stage i's strided down first (i > 0)
            for j in range(len(stage)):
                block(f"{layer}.{j}", f"stage{i}_down" if i and not j else f"stage{i}_subm{j}")
            continue
        n_res = len(stage) if i == n_stages - 1 else len(stage) - 1
        for j in range(n_res):
            name, prefix = f"stage{i}_res{j}", f"{layer}.{j}"
            for c in ("conv1", "conv2"):
                sd[f"{prefix}.{c}.weight"] = sparse_kernel_to_spconv(me[name][c]["kernel"],
                                                                     (3, 3, 3))
            for b in ("bn1", "bn2"):
                _bn(sd, f"{prefix}.{b}", me[name][b], mes[name][b])
        if i != n_stages - 1:
            block(f"{layer}.{n_res}", f"stage{i}_down")
    block(f"{enc}.conv_out", "conv_out", (3, 1, 1))

    _dense_body(sd, "pts_", params, batch_stats)

    sd.update(center_head_to_state_dict(params["pts_bbox_head"], batch_stats["pts_bbox_head"],
                                        "pts_bbox_head"))
    out = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    if "adversary" in params:
        adv = perturber_to_state_dict(params["adversary"], batch_stats["adversary"])
        out.update({f"adversary.{k}": v for k, v in adv.items()})
    return out


def center_head_to_state_dict(hp: Mapping, hs: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A JAX CenterHead's (params, batch_stats) -> the port CenterHead's
    state_dict entries under `prefix` (numpy arrays): shared conv + BN, and
    per task the heatmap and regression SeparateHeads and, for the DCN
    variant, the two feature adaptations."""
    from ..nn.deform_conv import dcn_kernel_to_weight

    pre = f"{prefix}." if prefix else ""
    sd: Dict[str, np.ndarray] = {}
    sd[f"{pre}shared_conv.conv.weight"] = _conv2d(hp["shared_conv"]["kernel"])
    _bn(sd, f"{pre}shared_conv.bn", hp["shared_bn"], hs["shared_bn"])
    t = 0
    while f"task{t}_heatmap" in hp:
        dst = f"{pre}task_heads.{t}"
        dcn = f"task{t}_adapt_cls" in hp
        _sep_head(sd, f"{dst}.cls_head" if dcn else f"{dst}.heatmap", hp[f"task{t}_heatmap"],
                  hs[f"task{t}_heatmap"])
        for name in ("reg", "height", "dim", "rot", "vel"):
            _sep_head(sd, f"{dst}.task_head.{name}" if dcn else f"{dst}.{name}",
                      hp[f"task{t}_{name}"], hs[f"task{t}_{name}"])
        for branch in ("cls", "reg") if dcn else ():
            p, s = hp[f"task{t}_adapt_{branch}"], hs[f"task{t}_adapt_{branch}"]
            kernel = _np(p["dcn"]["kernel"])
            a = f"{dst}.feature_adapt_{branch}"
            sd[f"{a}.dcn.weight"] = dcn_kernel_to_weight(
                kernel, kernel.shape[0] if kernel.ndim == 3 else 1).numpy()
            sd[f"{a}.dcn.conv_offset.weight"] = _conv2d(p["dcn"]["conv_offset"]["kernel"])
            sd[f"{a}.dcn.conv_offset.bias"] = _np(p["dcn"]["conv_offset"]["bias"])
            _bn(sd, f"{a}.bn", p["bn"], s["bn"])
        t += 1
    return sd
